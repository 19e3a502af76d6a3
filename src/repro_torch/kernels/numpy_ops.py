"""Numpy's arithmetic in plain PyTorch, bit for bit: the plain versions'
half of ``csrc/numpy_ops.cuh``.

The plain versions of the relational kernels (``expr_core_ref``,
``segment_reduce_ref``) compute with torch ops on the tensors' own device,
so they are written against what numpy does, not what torch does: every
operand is cast explicitly into numpy's loop dtype (torch's own promotion
differs: int / int is float32 by default, int64 + float32 float32),
integers wrap at their width, float16 is computed in float32 and rounded
once, and a NaN takes the host's bits (the first NaN operand quieted, or
the host's default NaN), which a card's arithmetic does not give.

A value is held in a *carrier*: an int64 tensor for bools and integers
(signed ones sign-extended, unsigned zero-extended, uint64 as its bits)
and a float16/32/64 tensor for floats.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["DTYPES", "DTYPE_CODES", "OPS", "host_nans", "carrier",
           "from_carrier", "to_f64", "to_f32", "f32_to_f16", "apply",
           "nonzero"]

DTYPES = tuple(np.dtype(c) for c in ("?", "i1", "i2", "i4", "i8", "u1",
                                     "u2", "u4", "u8", "f2", "f4", "f8"))
DTYPE_CODES = {dt: code for code, dt in enumerate(DTYPES)}
OPS = {"==": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5,
       "&&": 6, "||": 7, "!": 8, "+": 9, "-": 10, "*": 11, "/": 12}
CMP = ("==", "!=", "<", "<=", ">", ">=")
LOGICAL = ("&&", "||", "!")

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
_INT_TORCH = {8: torch.int8, 16: torch.int16, 32: torch.int32}
_U8, _I8 = np.dtype(np.uint64), np.dtype(np.int64)


def _signed(bits: int, width: int) -> int:
    """An unsigned bit pattern of ``width`` bits as the signed value torch
    scalars take."""
    return bits - (1 << width) if bits >= 1 << (width - 1) else bits


def host_nans() -> Tuple[int, int]:
    """The bits of the host's default NaN (numpy's 0/0) in float64 and in
    float32."""
    with np.errstate(all="ignore"):
        d = (np.zeros(1) / np.zeros(1)).view(np.uint64)[0]
        f = (np.zeros(1, np.float32) / np.zeros(1, np.float32))
    return int(d), int(f.view(np.uint32)[0])


def carrier(t: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """The carrier of a tensor holding a numpy column of dtype ``dt``
    (``transfer.torch_dtype``)."""
    if dt.kind == "f":
        return t
    x = t.to(torch.int64)
    if dt.kind == "u" and dt.itemsize in (2, 4):
        x = x & ((1 << (8 * dt.itemsize)) - 1)
    return x


def from_carrier(x: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """A carrier as the tensor of numpy dtype ``dt`` (its bits)."""
    from repro_torch.kernels.transfer import torch_dtype
    if dt.kind == "b":
        return x != 0
    return x.to(torch_dtype(dt))


def _with_sign(bits: torch.Tensor, negative: torch.Tensor) -> torch.Tensor:
    return torch.where(negative, bits | _I64_MIN, bits)


def _unsigned_to_float(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint64 bits (an int64 carrier) rounded to nearest into ``dtype``:
    halved with the lost bit kept as a sticky bit, converted, doubled."""
    half = ((x >> 1) & _I64_MAX) | (x & 1)
    return torch.where(x >= 0, x.to(dtype), half.to(dtype) * 2)


def to_f64(x: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """A carrier cast to float64 as numpy casts into a float64 loop:
    integers rounded to nearest, float32 NaNs quieted with their payload
    (x86 cvtss2sd), float16 NaNs with theirs unquieted."""
    if dt.kind != "f":
        return _unsigned_to_float(x, torch.float64) if dt == _U8 \
            else x.to(torch.float64)
    if dt.itemsize == 8:
        return x
    r = x.to(torch.float64)
    if dt.itemsize == 4:
        b = x.view(torch.int32).to(torch.int64)
        nan = (0x7ff8000000000000 | ((b & 0x7fffff) << 29))
    else:
        b = x.view(torch.int16).to(torch.int64)
        nan = 0x7ff0000000000000 | ((b & 0x3ff) << 42)
    nan = _with_sign(nan, b < 0).view(torch.float64)
    return torch.where(torch.isnan(x), nan, r)


def to_f32(x: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """A carrier cast to float32 as numpy casts into a float32 (or a
    float16, computed in float32) loop; float16 NaNs keep their payload."""
    if dt.kind != "f":
        return _unsigned_to_float(x, torch.float32) if dt == _U8 \
            else x.to(torch.float32)
    if dt.itemsize == 4:
        return x
    b = x.view(torch.int16).to(torch.int64)
    nan = (((b & 0x8000) << 16) | 0x7f800000 | ((b & 0x3ff) << 13))
    nan = nan.to(torch.int32).view(torch.float32)
    return torch.where(torch.isnan(x), nan, x.to(torch.float32))


def f32_to_f16(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even into float16, as numpy's
    npy_float_to_half: a NaN keeps the top of its payload and its sign."""
    b = x.view(torch.int32).to(torch.int64)
    m = (b & 0x7fffff) >> 13
    nan = ((b >> 16) & 0x8000) | 0x7c00 | torch.where(m == 0, 1, m)
    nan = nan.to(torch.int16).view(torch.float16)
    return torch.where(torch.isnan(x), nan, x.to(torch.float16))


def _nan_fix(r: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             dflt: int) -> torch.Tensor:
    """r with each NaN replaced by the host's: a's quieted, else b's, else
    the default NaN (an invalid operation)."""
    width = 8 * r.element_size()
    itype = torch.int64 if width == 64 else torch.int32
    quiet = 1 << (51 if width == 64 else 22)
    ab, bb = a.view(itype), b.view(itype)
    dbits = torch.full_like(ab, _signed(dflt, width))
    fix = torch.where(torch.isnan(a), ab | quiet,
                      torch.where(torch.isnan(b), bb | quiet, dbits))
    return torch.where(torch.isnan(r), fix.view(r.dtype), r)


def _arith_float(op: str, a: torch.Tensor, b: torch.Tensor, dflt: int
                 ) -> torch.Tensor:
    r = (a + b if op == "+" else a - b if op == "-" else a * b if op == "*"
         else a / b)
    return _nan_fix(r, a, b, dflt)


def _compare(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return {"==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
            ">": torch.gt, ">=": torch.ge}[op](a, b)


def nonzero(x: torch.Tensor) -> torch.Tensor:
    """numpy's truth of a value (a NaN is true, -0.0 false)."""
    return x != 0


def apply(op: str, a: torch.Tensor, da: np.dtype, b: torch.Tensor,
          db: np.dtype, la: np.dtype, lb: np.dtype,
          nans: Tuple[int, int]) -> torch.Tensor:
    """numpy's ufunc for ``op`` on carriers a (dtype da) and b (db) through
    its loop of input dtypes la, lb (``np.ufunc.resolve_dtypes``): the
    result's carrier (bools as int64 0/1)."""
    if op in LOGICAL:
        if op == "!":
            r = ~nonzero(a)
        elif op == "&&":
            r = nonzero(a) & nonzero(b)
        else:
            r = nonzero(a) | nonzero(b)
        return r.to(torch.int64)
    if op in CMP:
        if la != lb:  # numpy's exact int64 / uint64 comparison
            below = (a if la == _I8 else b) < 0  # the signed side: smaller
            fixed = (op == "!=") or (op in ("<", "<=") if la == _I8
                                     else op in (">", ">="))
            r = torch.where(below, torch.full_like(below, fixed),
                            _compare(op, a ^ _I64_MIN, b ^ _I64_MIN))
        elif la.kind == "f":
            cast = to_f64 if la.itemsize == 8 else to_f32
            r = _compare(op, cast(a, da), cast(b, db))
        elif la == _U8:
            r = _compare(op, a ^ _I64_MIN, b ^ _I64_MIN)
        else:
            r = _compare(op, a, b)
        return r.to(torch.int64)
    if la.kind == "f":
        if la.itemsize == 8:
            return _arith_float(op, to_f64(a, da), to_f64(b, db), nans[0])
        r = _arith_float(op, to_f32(a, da), to_f32(b, db), nans[1])
        return r if la.itemsize == 4 else f32_to_f16(r)
    if la.kind == "b":
        return a | b if op == "+" else a & b  # numpy: or, and
    r = a + b if op == "+" else a - b if op == "-" else a * b
    width = 8 * la.itemsize
    if width == 64:
        return r
    if la.kind == "i":
        return r.to(_INT_TORCH[width]).to(torch.int64)
    return r & ((1 << width) - 1)
