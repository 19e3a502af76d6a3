"""Build the port's CUDA sources and load them through ctypes.

Each source under ``csrc/`` has plain C entry points (no PyTorch headers)
and becomes one shared library, compiled with nvcc for sm_90a at first use
into ``build/repro_torch/`` (git-ignored) under a name that carries the
digest of the source, so an edited source is rebuilt and an unchanged one
is not. ``compile_all`` starts one nvcc per missing library, all at once,
and waits for every one of them. The ptxas report (registers, shared
memory, spills) is kept beside each library as ``.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterable, List

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "LaunchCounter", "nvcc_path",
           "compile_all", "load"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class LaunchCounter:
    """Launches of one kernel: its wrapper adds one per launch, nothing
    else adds to it."""
    count = 0


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
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
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


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The library built from ``source`` (compiled first if missing)."""
    lib, = compile_all([source])
    return ctypes.CDLL(str(lib))
