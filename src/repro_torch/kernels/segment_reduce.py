"""The relational pre-aggregation (K2): the wrapper of the hand-written
CUDA kernels in ``csrc/segment_reduce.cu`` and their plain versions.

Replaces the jitted segment reduction of the reference's JAX backend,
``repro/core/relops.py:562`` ``device_segment_reducer`` (``jax.jit`` of
``_core`` at :637): every accumulator column of one partition reduced into
its n group slots, byte-identical to numpy's ``np.add.at`` (sum: floats
into float64, bools into int64, integers in their own width, wrapping)
and ``np.minimum.at`` / ``np.maximum.at`` (into float64, from +-inf).

The work splits by what numpy's bytes require (the passes are in the
source): a stable radix sort of the row ids by group (``sort_plan``), then
each float sum as one chain of rounded adds in row order per (column,
group, element), because only that order gives ``np.add.at``'s bytes,
while integer sums and min / max, exact in any grouping, reduce in
parallel: long groups in ``LONG``-row pieces combined left to right. What
bounds it on an H100: the bytes are well under a millisecond at TPC-H
Q1's ~15 M-row partitions, but Q1 has 3 groups, so its float sums are
chains of millions of dependent adds: the largest group's rows x one DADD
latency (``dadd_chain`` measures it) is the floor.

The plain versions do the same in PyTorch on the host: ``sort_order_ref``
runs the sort plan's passes (a stable counting sort per digit places rows
where a stable sort by that digit does), float sums by ``torch.cumsum``
over each group's rows (the CPU kernel adds them in order), min / max as
the first NaN or the last row at the extreme, long groups by
``fold_pieces_ref`` (the kernel's pieces, combined left to right), integer
sums by ``index_add_`` (order-free); they return on the inputs' device.
The source is compiled with nvcc for sm_90a at first use and bound
through ctypes (``kernels/nvcc.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import numpy_ops as npo
from repro_torch.kernels import nvcc
from repro_torch.kernels.transfer import torch_dtype

__all__ = ["segment_reduce", "segment_reduce_ref", "sort_plan",
           "sort_order_ref", "fold_pieces_ref", "acc_dtype", "build",
           "dadd_chain", "LAUNCHES", "SOURCE", "COMBINERS", "LONG"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_reduce.cu"
COMBINERS = {"sum": 0, "min": 1, "max": 2}
MAX_COUNTS = 1 << 22     # (digit, chunk) counts of one sort pass
MAX_DIGIT_BITS = 11      # radix 2,048 at most
MAX_CHUNKS = 132 * 32    # a warp each: 32 a streaming multiprocessor
ROWS_PER_CHUNK = 256
SCAN_TILE = 4096         # counts per block of the scan (kScanTile)
LONG = 4096              # rows past which a group is long (kLong)
GATHER_INNER = 8         # float sums this narrow are gathered (kGatherInner)
RING_BLOCKS = 132 * 8    # blocks of ring_sums at most

LAUNCHES = nvcc.LaunchCounter()


def acc_dtype(dt: np.dtype, combiner: str) -> np.dtype:
    """The accumulator dtype numpy's scatter gives (the reference's
    ``relops.sum_acc_dtype`` for a sum, float64 for min / max)."""
    dt = np.dtype(dt)
    if combiner != "sum" or dt.kind == "f":
        return np.dtype(np.float64)
    return np.dtype(np.int64) if dt.kind == "b" else dt


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """The radix sort of ``rows`` group ids in [0, n] (n: a dropped row):
    ``passes`` of ``bits`` each, least significant digit first, over
    ``chunks`` chunks of ``chunk`` rows (a warp each)."""
    passes: int
    bits: int
    chunks: int
    chunk: int

    @property
    def counts(self) -> int:
        """(digit, chunk) counts of one pass."""
        return self.chunks << self.bits


def sort_plan(rows: int, n: int) -> SortPlan:
    """As few passes as digits of at most MAX_DIGIT_BITS cover the keys,
    the bits spread evenly over them; about ROWS_PER_CHUNK rows a chunk,
    as many chunks as MAX_COUNTS allows up to MAX_CHUNKS, so a pass has
    about min(rows / 256, 2,048) warps (a chunk each) at any n."""
    key_bits = max(1, int(n).bit_length())
    passes = -(-key_bits // MAX_DIGIT_BITS)
    bits = -(-key_bits // passes)
    rows = max(1, int(rows))
    chunks = max(1, min(-(-rows // ROWS_PER_CHUNK), MAX_COUNTS >> bits,
                        MAX_CHUNKS))
    chunk = -(-rows // chunks)
    return SortPlan(passes, bits, -(-rows // chunk), chunk)


def sort_order_ref(inv: torch.Tensor, n: int, plan: SortPlan = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sort plan's plain version: (order, starts), the row ids sorted
    by group (a row outside [0, n) last) and the (n + 1,) first slots of
    the groups (``starts[n]`` ends the rows kept). Each pass is a stable
    counting sort of one digit: rows of one digit keep their order, which
    is what a stable sort by that digit gives."""
    inv = inv.cpu()
    plan = plan or sort_plan(inv.shape[0], n)
    keys = torch.where((inv >= 0) & (inv < n), inv, torch.full_like(inv, n))
    order = torch.arange(inv.shape[0])
    mask = (1 << plan.bits) - 1
    for p in range(plan.passes):
        digit = (keys[order] >> (p * plan.bits)) & mask
        order = order[torch.argsort(digit, stable=True)]
    starts = torch.searchsorted(keys[order], torch.arange(n + 1))
    return order, starts


def _max_at(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """numpy's ``maximum.at`` step, a before b: a stays when NaN or
    strictly greater; else b (a tie, +-0.0 too, takes b)."""
    return torch.where((a > b) | torch.isnan(a), a, b)


def _min_at(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where((a < b) | torch.isnan(a), a, b)


def _extreme(seg: torch.Tensor, combiner: str) -> torch.Tensor:
    """numpy's ``maximum.at`` / ``minimum.at`` over one run of rows (a
    (rows, k) float64 tensor, row order) from +-inf: the first NaN if
    there is one, else the last row at the extreme (a tie replaces the
    accumulator)."""
    if seg.shape[0] == 0:
        return torch.full(seg.shape[1:], -torch.inf if combiner == "max"
                          else torch.inf, dtype=seg.dtype)
    isnan = torch.isnan(seg)
    first_nan = isnan.to(torch.int8).argmax(0)
    clean = torch.where(isnan, -torch.inf if combiner == "max" else torch.inf,
                        seg)
    best = clean.amax(0) if combiner == "max" else clean.amin(0)
    at_best = (clean == best).flip(0).to(torch.int8).argmax(0)
    last = seg.shape[0] - 1 - at_best
    pick = torch.where(isnan.any(0), first_nan, last)
    return seg.gather(0, pick[None]).squeeze(0)


def fold_pieces_ref(seg: torch.Tensor, combiner: str,
                    cuts: Sequence[int]) -> torch.Tensor:
    """The kernel's two levels for min / max over one group's rows (a
    (rows, k) float64 tensor, row order): each run between the ``cuts``
    folded alone, the partials combined left to right by numpy's rule
    (first NaN, else the later of two equal values)."""
    step = _max_at if combiner == "max" else _min_at
    bounds = [0] + [c for c in cuts if 0 < c < seg.shape[0]] + [seg.shape[0]]
    acc = None
    for s, e in zip(bounds[:-1], bounds[1:]):
        part = _extreme(seg[s:e], combiner)
        acc = part if acc is None else step(acc, part)
    return acc


@functools.lru_cache(maxsize=None)
def build() -> ctypes._CFuncPtr:
    """Compile the kernels (once per source content), load them and bind
    their C entry."""
    return nvcc.bind(nvcc.load(SOURCE), "repro_segment_reduce")


@functools.lru_cache(maxsize=None)
def _probe() -> ctypes._CFuncPtr:
    return nvcc.bind(nvcc.load(SOURCE), "repro_dadd_chain")


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


def _init(out: torch.Tensor, combiner: str) -> torch.Tensor:
    """numpy's initial accumulator."""
    return out.fill_(0 if combiner == "sum" else
                     (np.inf if combiner == "min" else -np.inf))


def _lanes(dtypes, combiners, inners) -> Tuple[List[int], List[int], int,
                                              int]:
    """Each column's first gathered lane (a float sum of inner width <=
    GATHER_INNER) and first order-free lane (an integer sum, min, max),
    -1 where it has none, and the two lane counts."""
    lane, ofl, n_g, n_of = [], [], 0, 0
    for dt, comb, inner in zip(dtypes, combiners, inners):
        chain = comb == "sum" and np.dtype(dt).kind == "f"
        lane.append(n_g if chain and inner <= GATHER_INNER else -1)
        ofl.append(-1 if chain else n_of)
        n_g += inner if lane[-1] >= 0 else 0
        n_of += inner if ofl[-1] >= 0 else 0
    return lane, ofl, n_g, n_of


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
    live = [j for j, o in enumerate(outs) if o.numel() and rows]
    for j in set(range(len(outs))) - set(live):
        _init(outs[j], combiners[j])
    if not live:
        return outs
    inners = [vals[j][:1].numel() for j in live]
    lane, ofl, n_g, n_of = _lanes([dtypes[j] for j in live],
                                  [combiners[j] for j in live], inners)
    plan = sort_plan(rows, n)

    def scratch(count, dtype=torch.int64):
        return torch.empty(max(1, count), dtype=dtype, device=dev)

    counts = scratch(plan.counts)
    tile_sums = scratch(-(-plan.counts // SCAN_TILE))
    keys = [scratch(rows), scratch(rows) if plan.passes > 1 else None]
    order = [scratch(rows), scratch(rows) if plan.passes > 1 else None]
    starts = scratch(n + 1)
    stride = rows + (rows & 1)  # 16-byte lanes
    gathered = scratch(n_g * stride, torch.float64) if n_g else None
    pieces = -(-rows // LONG)
    partials = scratch(2 * n_of * pieces) if n_of else None
    ring_cap = n_g * max(1, min(n, rows // (LONG + 1)))
    ring_list, ring_count = scratch(ring_cap), scratch(1)
    cols = []
    for j, q, o in zip(live, lane, ofl):
        cols += [vals[j].data_ptr(), outs[j].data_ptr(),
                 vals[j][:1].numel(), npo.DTYPE_CODES[np.dtype(dtypes[j])],
                 npo.DTYPE_CODES[accs[j]], COMBINERS[combiners[j]], q, o]
    nan64 = npo.host_nans()[0]

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    nvcc.launch(build(), "segment_reduce", dev.index, inv.data_ptr(), rows,
                n, plan.passes, plan.bits, plan.chunks, plan.chunk,
                counts.data_ptr(), tile_sums.data_ptr(), ptr(keys[0]),
                ptr(keys[1]), ptr(order[0]), ptr(order[1]),
                starts.data_ptr(), ptr(gathered), stride, ptr(partials),
                pieces, ring_list.data_ptr(), ring_count.data_ptr(),
                max(1, min(ring_cap, RING_BLOCKS)),
                nan64 - (1 << 64) if nan64 >> 63 else nan64, len(live),
                *cols)
    LAUNCHES.add()
    return outs


def dadd_chain(x: torch.Tensor, steps: int) -> torch.Tensor:
    """The DADD latency probe (not K2; counts no launch): one thread adds
    x[1] to x[0] ``steps`` times (a multiple of 8), each add waiting on the
    last; x: (2,) float64 on a card. Time it by events."""
    if x.device.type != "cuda" or x.dtype != torch.float64 \
            or x.shape != (2,) or steps % 8 or steps <= 0:
        raise ValueError("want (2,) float64 on a card and steps a positive "
                         "multiple of 8")
    out = torch.empty(1, dtype=torch.float64, device=x.device)
    nvcc.launch(_probe(), "dadd_chain",
                x.device.index, x.data_ptr(), steps, out.data_ptr())
    return out


def _reduce_float(x: torch.Tensor, comb: str, starts: torch.Tensor,
                  n: int) -> torch.Tensor:
    """(n, k) float64 accumulators of one column's sorted rows x: groups of
    at most LONG rows a row at a time for all of them together (the j-th
    rows of the groups that have one, one step of numpy's loop each),
    longer ones alone: a sum by ``torch.cumsum``, min / max in the
    kernel's pieces at multiples of LONG (``fold_pieces_ref``)."""
    init = 0.0 if comb == "sum" else (torch.inf if comb == "min"
                                      else -torch.inf)
    out = torch.full((n, x.shape[1]), init, dtype=torch.float64)
    step = {"sum": torch.add, "max": _max_at, "min": _min_at}[comb]
    lens = starts[1:] - starts[:-1]
    short = torch.nonzero((lens > 0) & (lens <= LONG)).squeeze(1)
    if short.numel():
        short = short[torch.argsort(lens[short], descending=True,
                                    stable=True)]
        first, size = starts[short], lens[short]
        acc = out[short]
        for j in range(int(size[0])):
            m = int(torch.count_nonzero(size > j))  # a prefix: sorted
            acc[:m] = step(acc[:m], x[first[:m] + j])
        out[short] = acc
    for g in torch.nonzero(lens > LONG).squeeze(1).tolist():
        s, e = int(starts[g]), int(starts[g + 1])
        seg = x[s:e]
        out[g] = seg.cumsum(0)[-1] if comb == "sum" else fold_pieces_ref(
            seg, comb, [p * LONG - s
                        for p in range(s // LONG + 1, -(-e // LONG))])
    return out


def segment_reduce_ref(inv: torch.Tensor, n: int,
                       vals: Sequence[torch.Tensor],
                       dtypes: Sequence[np.dtype], combiners: Sequence[str]
                       ) -> List[torch.Tensor]:
    """The plain version (on the host, see the module's note); returns on
    inv's device."""
    _check(inv, n, vals, dtypes, combiners)
    order, starts = sort_order_ref(inv, n)
    kept = int(starts[n])
    order = order[:kept]
    inv_sorted = inv.cpu()[order]
    outs = []
    for v, dt, comb in zip(vals, dtypes, combiners):
        dt = np.dtype(dt)
        acc = acc_dtype(dt, comb)
        x = npo.carrier(v.cpu().reshape(v.shape[0], -1), dt)[order]
        k = x.shape[1]
        if comb == "sum" and acc.kind != "f":  # integers: order-free
            out = torch.zeros(n, k, dtype=torch.int64).index_add_(
                0, inv_sorted, x)
        else:
            out = _reduce_float(npo.to_f64(x, dt), comb, starts, n)
        out = npo.from_carrier(out, acc).reshape((n,) + tuple(v.shape[1:]))
        outs.append(out.to(inv.device))
    return outs
