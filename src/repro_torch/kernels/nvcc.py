"""Build the port's CUDA sources and load them through ctypes.

Each source under ``csrc/`` has plain C entry points (no PyTorch headers)
and becomes one shared library, compiled with nvcc for sm_90a at first use
into ``build/repro_torch/`` (git-ignored) under a name that carries the
digest of the source and of the headers beside it (``csrc/*.cuh``), so an
edited source or header is rebuilt and an unchanged one is not.
``compile_all`` starts one nvcc per missing library, all at once, and waits
for every one of them. The ptxas report (registers, shared
memory, spills) is kept beside each library as ``.log``.

``launch`` is the lean call path of a kernel's C entry (``bind``): the
arguments packed into one block of int64, no Python context manager, the
device index handed to the C side (which switches device only when it
must), the raw handle of the device's current stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List

import torch

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "LaunchCounter", "nvcc_path",
           "compile_all", "load", "launch", "bind"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class LaunchCounter:
    """Launches of one kernel: its wrapper adds one per launch (``add``),
    nothing else adds to it. Counted under a lock, so threads launching at
    once (the worker runtime's ranks sharing a card) lose no count;
    ``count = 0`` resets it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._count = 0

    def add(self, k: int = 1) -> None:
        with self._lock:
            self._count += k

    @property
    def count(self) -> int:
        return self._count

    @count.setter
    def count(self, value: int) -> None:
        with self._lock:
            self._count = value


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME:
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def compile_all(sources: Iterable[Path]) -> List[Path]:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together; returns the libraries' paths. Raises
    with nvcc's report if any build fails, after every process ended."""
    sources = list(sources)
    libs = [_library_path(s) for s in sources]
    todo = [(s, lib) for s, lib in zip(sources, libs) if not lib.exists()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    try:
        for source, lib in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            log = open(f"{tmp}.log", "w+")
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp,
                                     str(source)],
                                    stdout=log, stderr=subprocess.STDOUT)
            jobs.append((source, lib, tmp, log, proc))
        failed = []
        for source, lib, tmp, log, proc in jobs:
            proc.wait()
            log.seek(0)
            report = log.read()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {source}:\n{report}")
                continue
            lib.with_suffix(".log").write_text(report)
            os.replace(tmp, lib)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, log, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            for path in (tmp, f"{tmp}.log"):
                if os.path.exists(path):
                    os.unlink(path)
    return libs


_LOADED: Dict[Path, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def load(source: Path) -> ctypes.CDLL:
    """The library built from ``source`` (compiled first if missing), loaded
    once per process. Under a lock: threads reaching a kernel at once (the
    worker runtime's ranks) start one build of it, not one each, and the
    others wait for it. Across processes the build stays safe because
    ``compile_all`` writes each library under a temporary name and renames
    it into place."""
    with _LOAD_LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            path, = compile_all([source])
            lib = _LOADED[source] = ctypes.CDLL(str(path))
        return lib


def launch(fn: ctypes._CFuncPtr, name: str, index: int, *args: int) -> None:
    """Call a kernel's C entry ``fn(block, n)`` on the current stream of
    CUDA device ``index`` and raise RuntimeError on the CUDA error it
    returns (``cudaGetLastError()`` after the launch). ``block`` holds the
    n int64 ``index, *args, stream``, packed by one ``struct.pack``: one
    ctypes argument to convert instead of one per argument, the larger
    part of a small kernel's host path. The stream is the one
    ``torch.cuda.current_stream(index)`` stands for, read as its raw handle
    without building a Stream object. The C entry makes the device current
    only when it is not already, and restores the caller's afterwards."""
    n = len(args) + 2
    block = struct.pack(f"{n}q", index, *args,
                        torch._C._cuda_getCurrentRawStream(index))
    err = fn(block, n)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def bind(lib: ctypes.CDLL, symbol: str) -> ctypes._CFuncPtr:
    """The C entry ``int symbol(const int64_t* block, int n)`` of a library
    called through ``launch``."""
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn
