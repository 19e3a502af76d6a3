"""Numpy columns to and from a device for the relational kernels.

The relational engine keeps its batches in numpy on the host; its two
device functions (``expr_core``, ``segment_reduce``) take tensors. A tensor
here holds its numpy column bit for bit: in the torch dtype of the same
kind and width, or, for unsigned integers of 16-64 bits (which torch
barely computes on), in the signed type of the width.

On a card the columns travel through pinned (page-locked) host memory
that is reused: one ``Staging`` buffer per (device, use) in the process,
grown to the largest request and never shrunk, shared by the threads
that use it (the worker runtime's ranks, the service's queries): a
thread holds the buffer's ``lock`` from filling it until the card's last
read of it is done (K1) or queued behind a recorded event (K2), so the
pinned memory a process holds does not grow with its threads.
``Staging.pack`` copies columns, each given as the parts (a partition's
batches) whose concatenation it is, straight into the buffer, 16-byte
aligned, and hands out tensor views of it. The card reads such a view
through its device-mapped address (K1), or ``to_device_pinned`` moves the
whole buffer in one asynchronous copy (K2). A buffer is refilled only
after the last copy or launch that read it has ended (its recorded
event).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["torch_dtype", "card", "to_device", "Staging", "staging",
           "to_device_pinned"]

# numpy dtype -> (torch dtype, numpy dtype of the same bits as that tensor)
_HOLDERS = {
    np.dtype(np.bool_): (torch.bool, np.bool_),
    np.dtype(np.int8): (torch.int8, np.int8),
    np.dtype(np.int16): (torch.int16, np.int16),
    np.dtype(np.int32): (torch.int32, np.int32),
    np.dtype(np.int64): (torch.int64, np.int64),
    np.dtype(np.uint8): (torch.uint8, np.uint8),
    np.dtype(np.uint16): (torch.int16, np.int16),
    np.dtype(np.uint32): (torch.int32, np.int32),
    np.dtype(np.uint64): (torch.int64, np.int64),
    np.dtype(np.float16): (torch.float16, np.float16),
    np.dtype(np.float32): (torch.float32, np.float32),
    np.dtype(np.float64): (torch.float64, np.float64),
}
_ALIGN = 16
_GROW = 1 << 20  # a staging buffer grows in whole MiB


def torch_dtype(dt: np.dtype) -> torch.dtype:
    """The torch dtype that holds a numpy column of dtype ``dt`` bit for
    bit; TypeError for a dtype the relational kernels do not take."""
    try:
        return _HOLDERS[np.dtype(dt)][0]
    except KeyError:
        raise TypeError(f"the relational kernels take the native numpy "
                        f"bool, integer and float16/32/64 dtypes, not "
                        f"{np.dtype(dt)}") from None


def card(device) -> torch.device:
    """``device`` with its index: a bare "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _numpy_view(a: np.ndarray) -> np.ndarray:
    """``a`` flattened and contiguous, viewed in the numpy dtype of its
    tensor (signed for unsigned 16-64-bit integers)."""
    torch_dtype(a.dtype)  # refuses what the kernels do not take
    return np.ascontiguousarray(a).reshape(-1).view(_HOLDERS[a.dtype][1])


def _offsets(sizes: Sequence[int]) -> Tuple[List[int], int]:
    offs, total = [], 0
    for size in sizes:
        offs.append(total)
        total += -(-size // _ALIGN) * _ALIGN
    return offs, max(total, _ALIGN)


def to_device(arrays: Sequence[np.ndarray], device: torch.device
              ) -> List[torch.Tensor]:
    """Each array as a flat tensor on ``device``: on the CPU sharing
    contiguous arrays' memory; on a card views of one buffer, filled by
    one copy through a ``staging`` buffer."""
    if device.type == "cpu":
        return [torch.from_numpy(_numpy_view(a)) for a in arrays]
    return to_device_pinned([[a] for a in arrays], device)


def _column_dtype(parts: Sequence[np.ndarray]) -> np.dtype:
    dts = {p.dtype for p in parts}
    if len(dts) != 1:
        raise TypeError(f"a column's parts must share one dtype; got "
                        f"{sorted(map(str, dts))}")
    dt = dts.pop()
    torch_dtype(dt)  # refuses what the kernels do not take
    return dt


def _copy_parts(dst: np.ndarray, parts: Sequence[np.ndarray]) -> None:
    """dst (flat, the holder dtype) filled with the parts in order."""
    at = 0
    for p in parts:
        dst[at:at + p.size] = p.reshape(-1).view(dst.dtype)
        at += p.size


class Staging:
    """A pinned host buffer reused across calls (see the module's note):
    ``reserve`` waits for the last recorded use, then grows the buffer if
    it is smaller than asked."""

    def __init__(self, pinned: bool = True) -> None:
        self.pinned = pinned  # False: pageable, for tests without a card
        self.buf: Optional[torch.Tensor] = None  # uint8
        self.event: Optional[torch.cuda.Event] = None
        self.lock = threading.Lock()  # held by the thread using the buffer

    def reserve(self, nbytes: int) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = None  # release the old block before the new one
            self.buf = torch.empty(-(-nbytes // _GROW) * _GROW,
                                   dtype=torch.uint8,
                                   pin_memory=self.pinned)
        return self.buf

    def record(self, device: torch.device) -> None:
        """Mark the buffer as read by the work queued so far on
        ``device``'s current stream."""
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(device))

    def pack(self, columns: Sequence[Sequence[np.ndarray]]
             ) -> Tuple[List[torch.Tensor], int]:
        """Each column, given as its parts, copied into the buffer; returns
        a flat pinned tensor view per column and the bytes used."""
        dts = [_column_dtype(parts) for parts in columns]
        sizes = [sum(p.nbytes for p in parts) for parts in columns]
        offs, total = _offsets(sizes)
        host = self.reserve(total).numpy()
        dsts = [host[off:off + size].view(_HOLDERS[dt][1])
                for dt, off, size in zip(dts, offs, sizes)]
        for dst, parts in zip(dsts, columns):
            _copy_parts(dst, parts)
        return [self.buf[off:off + size].view(torch_dtype(dt))
                for dt, off, size in zip(dts, offs, sizes)], total

    def views(self, specs: Sequence[Tuple[int, np.dtype]]
              ) -> List[torch.Tensor]:
        """Uninitialised flat pinned views for (count, numpy dtype) specs,
        for a kernel's outputs."""
        offs, total = _offsets([count * np.dtype(dt).itemsize
                                for count, dt in specs])
        buf = self.reserve(total)
        return [buf[o:o + count * np.dtype(dt).itemsize].view(torch_dtype(dt))
                for (count, dt), o in zip(specs, offs)]


_BUFFERS: Dict[Tuple[torch.device, str], Staging] = {}
_BUFFERS_LOCK = threading.Lock()
_THREAD = threading.local()


def staging(device: torch.device, use: str) -> Staging:
    """The process's staging buffer of ``use`` for ``device``, made at
    first use; its user holds its ``lock`` (see the module's note). A
    thread's first call for a card also binds the card's context to the
    thread (a stream wait does): a new thread (a worker rank) finds the
    buffers made, and may make no other CUDA call before a kernel's C
    entry asks ``cudaPointerGetAttributes`` about a pinned pointer, which
    refuses it (error 16) unless the context is current."""
    dev = card(device)
    if dev.type == "cuda":
        bound = _THREAD.__dict__.setdefault("devices", set())
        if dev not in bound:
            torch.cuda.current_stream(dev).synchronize()
            bound.add(dev)
    with _BUFFERS_LOCK:
        buf = _BUFFERS.get((dev, use))
        if buf is None:
            buf = _BUFFERS[(dev, use)] = Staging()
    return buf


def to_device_pinned(columns: Sequence[Sequence[np.ndarray]],
                     device: torch.device, use: str = "to_device"
                     ) -> List[torch.Tensor]:
    """Each column (given as its parts) as a flat tensor on the card
    ``device``: packed into the ``use`` staging buffer, then moved in one
    asynchronous copy on the current stream into one device buffer whose
    views are returned."""
    stage = staging(device, use)
    with stage.lock:
        views, total = stage.pack(columns)
        dev = torch.empty(total, dtype=torch.uint8, device=device)
        dev.copy_(stage.buf[:total], non_blocking=True)
        stage.record(device)
        base = stage.buf.data_ptr()
    return [dev[v.data_ptr() - base:v.data_ptr() - base + v.nbytes]
            .view(v.dtype) for v in views]
