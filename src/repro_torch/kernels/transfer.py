"""Numpy columns to and from a device for the relational kernels.

The relational engine keeps its batches in numpy on the host; its two
device functions (``expr_core``, ``segment_reduce``) take tensors. A tensor
here holds its numpy column bit for bit: in the torch dtype of the same
kind and width, or, for unsigned integers of 16-64 bits (which torch
barely computes on), in the signed type of the width. On a card the
columns of one call travel in one copy each way: packed into one buffer
16-byte aligned, and handed out as views of it.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["torch_dtype", "to_device", "device_buffer", "to_host"]

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


def torch_dtype(dt: np.dtype) -> torch.dtype:
    """The torch dtype that holds a numpy column of dtype ``dt`` bit for
    bit; TypeError for a dtype the relational kernels do not take."""
    try:
        return _HOLDERS[np.dtype(dt)][0]
    except KeyError:
        raise TypeError(f"the relational kernels take the native numpy "
                        f"bool, integer and float16/32/64 dtypes, not "
                        f"{np.dtype(dt)}") from None


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
    """Each array as a flat tensor on ``device``. On the CPU the tensors
    share contiguous arrays' memory; on a card they are views of one
    buffer, filled by one host-to-device copy."""
    flats = [_numpy_view(a) for a in arrays]
    if device.type == "cpu":
        return [torch.from_numpy(f) for f in flats]
    offs, total = _offsets([f.nbytes for f in flats])
    host = np.empty(total, np.uint8)
    for f, o in zip(flats, offs):
        host[o:o + f.nbytes] = f.view(np.uint8)
    buf = torch.from_numpy(host).to(device)
    return [buf[o:o + f.nbytes].view(torch_dtype(a.dtype))
            for a, f, o in zip(arrays, flats, offs)]


def device_buffer(device: torch.device,
                  specs: Sequence[Tuple[int, np.dtype]]
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One uninitialised buffer on ``device`` and a flat tensor view of it
    per (count, numpy dtype) spec, for results that ``to_host`` brings
    back in one copy."""
    offs, total = _offsets([count * np.dtype(dt).itemsize
                            for count, dt in specs])
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    views = [buf[o:o + count * np.dtype(dt).itemsize].view(torch_dtype(dt))
             for (count, dt), o in zip(specs, offs)]
    return buf, views


def to_host(buf: torch.Tensor, specs: Sequence[Tuple[int, np.dtype]]
            ) -> List[np.ndarray]:
    """The spec'd columns of a ``device_buffer``, in one device-to-host
    copy, as numpy arrays of their own dtypes."""
    host = buf.cpu().numpy()
    offs, _ = _offsets([count * np.dtype(dt).itemsize for count, dt in specs])
    return [host[o:o + count * np.dtype(dt).itemsize].view(dt)
            for (count, dt), o in zip(specs, offs)]
