"""The relational kernels' scalar arithmetic (``kernels/csrc/numpy_ops.cuh``)
compiled for the host and held against numpy's bytes: the header is
``__host__ __device__`` and needs no CUDA header under a host compiler,
so the conversions, the divisions' NaN rule and every
(op, dtype pair) of ``npops::apply`` run here bit for bit, without a
card. Skips (inside the fixture) where there is no C++ compiler."""
import ctypes
import itertools
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np
import pytest

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")

_HARNESS = r"""
#include <stdint.h>
#include "numpy_ops.cuh"
using namespace npops;
extern "C" {
void apply_vec(int op, const uint64_t* a, int da, const uint64_t* b, int db,
               int la, int lb, uint64_t n64, uint32_t n32, uint64_t* out,
               int64_t n) {
  NanBits nb; nb.f64 = n64; nb.f32 = n32;
  for (int64_t i = 0; i < n; ++i) out[i] = apply(op, a[i], da, b[i], db,
                                                 la, lb, nb);
}
void f32_to_f16(const uint32_t* f, uint16_t* h, int64_t n) {
  for (int64_t i = 0; i < n; ++i) h[i] = (uint16_t)f32_to_f16_bits(f[i]);
}
void f16_to_f32(const uint16_t* h, uint32_t* f, int64_t n) {
  for (int64_t i = 0; i < n; ++i) f[i] = f16_to_f32_bits(h[i]);
}
void f16_to_f64(const uint16_t* h, uint64_t* f, int64_t n) {
  for (int64_t i = 0; i < n; ++i) f[i] = f16_to_f64_bits(h[i]);
}
void div_f64(const uint64_t* a, const uint64_t* b, uint64_t* o, int64_t n,
             uint64_t d) {
  for (int64_t i = 0; i < n; ++i) o[i] = arith64(kDiv, a[i], b[i], d);
}
void div_f32(const uint32_t* a, const uint32_t* b, uint32_t* o, int64_t n,
             uint32_t d) {
  for (int64_t i = 0; i < n; ++i) o[i] = arith32(kDiv, a[i], b[i], d);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of numpy_ops.cuh")
    out = tmp_path_factory.mktemp("numpy_ops")
    src = out / "harness.cpp"
    src.write_text(_HARNESS)
    so = out / "libnumpy_ops.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(src)], check=True,
                   timeout=120)
    lib = ctypes.CDLL(str(so))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.apply_vec.argtypes = [ctypes.c_int, p, ctypes.c_int, p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                              ctypes.c_uint32, p, i64]
    for name in ("f32_to_f16", "f16_to_f32", "f16_to_f64"):
        getattr(lib, name).argtypes = [p, p, i64]
    lib.div_f64.argtypes = [p, p, p, i64, ctypes.c_uint64]
    lib.div_f32.argtypes = [p, p, p, i64, ctypes.c_uint32]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _nans():
    from repro_torch.kernels.numpy_ops import host_nans
    return host_nans()


def test_half_conversions_match_numpy_bit_for_bit(lib):
    h = np.arange(1 << 16, dtype=np.uint16)  # every float16
    f = np.empty(h.size, np.uint32)
    lib.f16_to_f32(_ptr(h), _ptr(f), h.size)
    assert np.array_equal(f, h.view(np.float16).astype(np.float32)
                          .view(np.uint32))
    d = np.empty(h.size, np.uint64)
    lib.f16_to_f64(_ptr(h), _ptr(d), h.size)
    assert np.array_equal(d, h.view(np.float16).astype(np.float64)
                          .view(np.uint64))
    rng = np.random.default_rng(0)
    # random float32 patterns, and every pattern around the half's range
    # edges (subnormal ties, the overflow point)
    f = np.concatenate([
        rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64).astype(np.uint32),
        np.arange(0x32ff0000, 0x39000000, 7, dtype=np.uint32),
        np.arange(0x477f0000, 0x47800100, dtype=np.uint32)])
    f = np.concatenate([f, f | np.uint32(0x80000000)])
    got = np.empty(f.size, np.uint16)
    lib.f32_to_f16(_ptr(f), _ptr(got), f.size)
    with np.errstate(all="ignore"):
        want = f.view(np.float32).astype(np.float16).view(np.uint16)
    assert np.array_equal(got, want)


def _patterns(rng, n, width):
    """Random bit patterns, random normals, results near the subnormal
    range, and every pair of special values."""
    ft, ut = {8: (np.float64, np.uint64), 4: (np.float32, np.uint32)}[width]
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 3.0,
                        0.1, np.finfo(ft).tiny, np.finfo(ft).max,
                        np.finfo(ft).smallest_subnormal,
                        np.finfo(ft).tiny - np.finfo(ft).smallest_subnormal],
                       ft).view(ut)
    hi = 1 << (8 * width)
    a = [rng.integers(0, hi, n, dtype=np.uint64).astype(ut),
         rng.standard_normal(n).astype(ft).view(ut),
         (rng.random(n) * np.finfo(ft).tiny * 64).astype(ft).view(ut),
         np.repeat(special, special.size)]
    b = [rng.integers(0, hi, n, dtype=np.uint64).astype(ut),
         rng.standard_normal(n).astype(ft).view(ut),
         (rng.random(n) * 64 + 1).astype(ft).view(ut),
         np.tile(special, special.size)]
    return np.concatenate(a), np.concatenate(b)


@pytest.mark.parametrize("width", [8, 4])
def test_hand_written_division_is_numpys(lib, width):
    """``arith64`` / ``arith32`` division (the host's IEEE division here,
    ``__ddiv_rn`` / ``__fdiv_rn`` on the card) with the host's NaN rule,
    over special values and subnormal results."""
    rng = np.random.default_rng(width)
    a, b = _patterns(rng, 1 << 18, width)
    got = np.empty_like(a)
    d64, d32 = _nans()
    if width == 8:
        lib.div_f64(_ptr(a), _ptr(b), _ptr(got), a.size, d64)
        ft = np.float64
    else:
        lib.div_f32(_ptr(a), _ptr(b), _ptr(got), a.size, d32)
        ft = np.float32
    with np.errstate(all="ignore"):
        want = (a.view(ft) / b.view(ft)).view(a.dtype)
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, [(hex(a[i]), hex(b[i]), hex(got[i]), hex(want[i]))
                           for i in bad[:4]]


_UFUNCS = {"==": np.equal, "!=": np.not_equal, "<": np.less,
           "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
           "+": np.add, "-": np.subtract, "*": np.multiply,
           "/": np.true_divide, "&&": np.logical_and, "||": np.logical_or}
_DTYPES = ["?", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f2", "f4",
           "f8"]


def _register(x):
    """A column as the kernel's 64-bit registers: signed integers
    sign-extended, the rest zero-extended bits."""
    if x.dtype.kind == "i":
        return x.astype(np.int64).view(np.uint64)
    if x.dtype.kind == "f":
        return x.view({2: np.uint16, 4: np.uint32,
                       8: np.uint64}[x.itemsize]).astype(np.uint64)
    return x.astype(np.uint64)


@pytest.mark.parametrize("op", list(_UFUNCS))
def test_apply_matches_numpy_for_every_dtype_pair(lib, op):
    """``npops::apply`` through the loop dtypes ``expr_core.encode`` gives
    it, against numpy's bytes, over every dtype pair numpy computes."""
    from repro_torch.kernels import expr_core as ec
    from repro_torch.kernels.numpy_ops import DTYPE_CODES, OPS
    rng = np.random.default_rng(sum(map(ord, op)))
    n, d64, d32 = 512, *_nans()
    for da, db in itertools.product(_DTYPES, _DTYPES):
        a, b = (np.asarray(_values(rng, d, n)) for d in (da, db))
        try:
            with np.errstate(all="ignore"), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = _UFUNCS[op](a, b)
        except TypeError:  # numpy refuses it (bool - bool)
            continue
        prog = ec.encode([(op, 2, (0, 1))],
                         {0: a.dtype, 1: b.dtype, 2: want.dtype}, [0, 1], [2])
        (_, _, _, la, lb, _, _, _), = prog.instrs
        ra, rb = _register(a), _register(b)
        out = np.empty(n, np.uint64)
        lib.apply_vec(OPS[op], _ptr(ra), DTYPE_CODES[a.dtype], _ptr(rb),
                      DTYPE_CODES[b.dtype], DTYPE_CODES[la], DTYPE_CODES[lb],
                      d64, d32, _ptr(out), n)
        got = out.astype({1: np.uint8, 2: np.uint16, 4: np.uint32,
                          8: np.uint64}[want.itemsize]).view(want.dtype)
        assert got.tobytes() == want.tobytes(), (da, op, db)


def _values(rng, dt, n):
    """Random values of dt and its edge values; a NaN only meets NaNs of
    its own bits (numpy's choice between two NaNs depends on its path)."""
    dt = np.dtype(dt)
    if dt.kind == "b":
        return rng.integers(0, 2, n).astype(bool)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        v[:4] = np.array([info.min, info.max, 0, 1], dt)
        return v
    with np.errstate(over="ignore"):
        v = (rng.standard_normal(n) * 10.0 ** rng.integers(-5, 6, n)
             ).astype(dt)
    v[:6] = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0]).astype(dt)
    return v
