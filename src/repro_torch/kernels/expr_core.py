"""The fused expression core (K1): the wrapper of the hand-written CUDA
kernel in ``csrc/expr_core.cu``, its plain version, and the encoder of the
instruction lists both run.

Replaces the jitted numeric core of the reference's JAX expression
backend, ``repro/core/exprc.py:490`` ``_compile_jax`` (``jax.jit`` of
``_core`` at :527): the compare / bool / arith DAG of one fused
APPLY/FILTER/HASH run, evaluated over the columns of one batch in every
numpy numeric dtype (``_jaxable``: kinds b, i, u, f), with numpy's bytes.

``encode`` turns the run's core into an ``ExprProgram`` once per run
signature: registers for the core's inputs and values, and per
instruction numpy's loop dtypes (``np.ufunc.resolve_dtypes`` of its two
input dtypes), so the kernel computes each op in the type numpy computes
it in (int / int in float64, int64 against uint64 exactly when numpy
compares them so, int64 with float32 in float64, float16 in float32
rounded once). The kernel interprets the program, a thread per element;
``expr_core_ref`` interprets the same program with torch ops
(``numpy_ops.py``).

What bounds it on an H100: at the executor's 8,192-row batches a call
moves a few hundred KB (a fraction of a microsecond at 3.35 TB/s). On the
engine's path the kernel reads its inputs from pinned host memory through
their device-mapped address and writes its outputs there too, so a batch
is one pack, one launch and one wait: the bytes over the host link and
the launch are its time. The source is compiled with nvcc for sm_90a at
first use and bound through ctypes (``kernels/nvcc.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import numpy_ops as npo
from repro_torch.kernels import nvcc
from repro_torch.kernels.transfer import card, torch_dtype

__all__ = ["ExprProgram", "encode", "expr_core", "expr_core_ref", "build",
           "LAUNCHES", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "expr_core.cu"
MAX_IN, MAX_OUT, MAX_REGS = 64, 64, 128  # the kernel's (expr_core.cu)

LAUNCHES = nvcc.LaunchCounter()

_UFUNCS = {"==": np.equal, "!=": np.not_equal, "<": np.less,
           "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
           "+": np.add, "-": np.subtract, "*": np.multiply,
           "/": np.true_divide}
_MIXED = {np.dtype(np.int64), np.dtype(np.uint64)}


class ExprProgram:
    """One fused run's numeric core as registers and instructions.

    ``in_dtypes``: the dtype of each input register (0..n_in-1);
    ``instrs``: (op, a, b, la, lb, da, db, dst) with registers a, b of
    dtypes da, db computed through numpy's loop dtypes la, lb into dst;
    ``outputs`` / ``out_dtypes``: the registers returned; ``words``: the
    int32 program the kernel reads (layout in ``expr_core.cu``)."""

    def __init__(self, in_dtypes, instrs, outputs, out_dtypes, n_regs):
        self.in_dtypes: Tuple[np.dtype, ...] = tuple(in_dtypes)
        self.instrs: Tuple[tuple, ...] = tuple(instrs)
        self.outputs: Tuple[int, ...] = tuple(outputs)
        self.out_dtypes: Tuple[np.dtype, ...] = tuple(out_dtypes)
        self.n_regs = n_regs
        self.nans = npo.host_nans()
        code = npo.DTYPE_CODES
        d64, f32 = self.nans
        words = [len(self.in_dtypes), len(self.instrs), len(self.outputs),
                 n_regs, d64 & 0xffffffff, d64 >> 32, f32]
        words += [code[dt] for dt in self.in_dtypes]
        for op, a, b, la, lb, da, db, dst in self.instrs:
            words += [npo.OPS[op], a, b, code[la], code[lb], code[da],
                      code[db], dst]
        for reg, dt in zip(self.outputs, self.out_dtypes):
            words += [reg, code[dt]]
        self.words = np.array(words, dtype=np.uint32).view(np.int32)
        self._on_device: Dict[torch.device, torch.Tensor] = {}

    def device_words(self, device: torch.device) -> torch.Tensor:
        """The program on ``device``, copied there once. The copy is waited
        for before the words are shared: threads on other streams (the
        worker runtime's ranks) launch the same program."""
        words = self._on_device.get(device)
        if words is None:
            words = torch.from_numpy(self.words).to(device)
            if words.is_cuda:
                torch.cuda.current_stream(device).synchronize()
            self._on_device[device] = words
        return words


def _kernel_dtype(dt) -> np.dtype:
    dt = np.dtype(dt)
    if dt not in npo.DTYPE_CODES:
        raise TypeError(f"the expression core takes the native numpy bool, "
                        f"integer and float16/32/64 dtypes, not {dt}")
    return dt


def encode(instrs: Sequence[Tuple[str, int, Tuple[int, ...]]],
           dtypes: Mapping[int, np.dtype], inputs: Sequence[int],
           outputs: Sequence[int]) -> ExprProgram:
    """The program of a run's core: ``instrs`` are (op, out slot, input
    slots) in order, ``dtypes`` every slot's dtype (the schedule's
    zero-row probe), ``inputs`` the slots read from the host, ``outputs``
    the slots returned. Raises TypeError where numpy's loop for an op is
    not one the kernel computes or disagrees with the probe's dtype, and
    ValueError past the kernel's register and column limits."""
    reg: Dict[int, int] = {s: i for i, s in enumerate(inputs)}
    prog = []
    for op, out, ins in instrs:
        a = ins[0]
        b = ins[1] if len(ins) > 1 else a
        da, db = _kernel_dtype(dtypes[a]), _kernel_dtype(dtypes[b])
        want = _kernel_dtype(dtypes[out])
        if op in npo.LOGICAL:
            la, lb, lo = da, db, np.dtype(np.bool_)
        else:
            la, lb, lo = (np.dtype(d) for d in
                          _UFUNCS[op].resolve_dtypes((da, db, None)))
            _kernel_dtype(la), _kernel_dtype(lb)
            if la != lb and {la, lb} != _MIXED:
                raise TypeError(f"numpy's loop for {da} {op} {db} takes "
                                f"{la} and {lb}; the core computes equal "
                                f"loop dtypes or int64 against uint64")
        if lo != want:
            raise TypeError(f"numpy computes {da} {op} {db} into {lo}, the "
                            f"schedule recorded {want}")
        reg[out] = len(reg)
        prog.append((op, reg[a], reg[b], la, lb, da, db, reg[out]))
    n_regs = len(reg)
    if len(inputs) > MAX_IN or len(outputs) > MAX_OUT or n_regs > MAX_REGS:
        raise ValueError(f"a core of {len(inputs)} inputs, {len(outputs)} "
                         f"outputs and {n_regs} values is past the kernel's "
                         f"{MAX_IN}, {MAX_OUT} and {MAX_REGS}")
    return ExprProgram([_kernel_dtype(dtypes[s]) for s in inputs], prog,
                       [reg[s] for s in outputs],
                       [_kernel_dtype(dtypes[s]) for s in outputs], n_regs)


@functools.lru_cache(maxsize=None)
def build() -> ctypes._CFuncPtr:
    """Compile the kernel (once per source content), load it and bind its
    C entry."""
    return nvcc.bind(nvcc.load(SOURCE), "repro_expr_core")


def check_inputs(program: ExprProgram, inputs: Sequence[torch.Tensor],
                 n: int) -> None:
    """One flat tensor per input register, of its dtype's holder
    (``transfer.torch_dtype``), with n elements or one (a constant)."""
    if len(inputs) != len(program.in_dtypes):
        raise ValueError(f"the program reads {len(program.in_dtypes)} "
                         f"inputs, got {len(inputs)}")
    for k, (x, dt) in enumerate(zip(inputs, program.in_dtypes)):
        if x.dtype != torch_dtype(dt) or x.dim() != 1 \
                or x.shape[0] not in (n, 1):
            raise ValueError(f"input {k}: want ({n},) or (1,) of "
                             f"{torch_dtype(dt)} for {dt}; got "
                             f"{tuple(x.shape)} {x.dtype}")


def expr_core(program: ExprProgram, inputs: Sequence[torch.Tensor], n: int,
              outs: Optional[Sequence[torch.Tensor]] = None,
              device: Optional[torch.device] = None) -> List[torch.Tensor]:
    """Launch the CUDA kernel on ``device`` (the inputs' CUDA device when
    None): ``inputs`` as ``check_inputs`` says, contiguous, each in that
    device's memory or in pinned host memory (read through its
    device-mapped address; the C entry refuses pageable memory with CUDA
    error 16, cudaErrorInvalidHostPointer). Returns one (n,) tensor per
    program output, on the device unless written into ``outs``
    (contiguous tensors of the outputs' holders, device or pinned host
    memory), on the current stream: the caller waits for it before
    reading pinned outputs."""
    check_inputs(program, inputs, n)
    dev = card(device) if device is not None else inputs[0].device
    if dev.type != "cuda" or any(x.device.type == "cuda" and x.device != dev
                                 for x in inputs):
        raise ValueError("the expression core's inputs must lie on its CUDA "
                         "device or in pinned host memory")
    if not all(x.is_contiguous() for x in inputs):
        raise ValueError("the expression core's inputs must be contiguous")
    if outs is None:
        outs = [torch.empty(n, dtype=torch_dtype(dt), device=dev)
                for dt in program.out_dtypes]
    elif len(outs) != len(program.out_dtypes) or any(
            (o.device.type == "cuda" and o.device != dev)
            or o.shape != (n,) or not o.is_contiguous()
            or o.dtype != torch_dtype(dt)
            for o, dt in zip(outs, program.out_dtypes)):
        raise ValueError("outs: want a contiguous (n,) tensor of each "
                         "output's holder on the device or in pinned host "
                         "memory")
    if n == 0:
        return list(outs)
    words = program.device_words(dev)
    steps = [0 if x.shape[0] == 1 and n > 1 else 1 for x in inputs]
    nvcc.launch(build(), "expr_core", dev.index, words.data_ptr(),
                words.numel(), program.n_regs, n, len(inputs), len(outs),
                *(x.data_ptr() for x in inputs), *steps,
                *(o.data_ptr() for o in outs))
    LAUNCHES.add()
    return list(outs)


def expr_core_ref(program: ExprProgram, inputs: Sequence[torch.Tensor],
                  n: int) -> List[torch.Tensor]:
    """The plain version: the same program, one torch op per instruction on
    the inputs' device (``numpy_ops.apply``)."""
    check_inputs(program, inputs, n)
    regs: List[Optional[torch.Tensor]] = [None] * program.n_regs
    for k, (x, dt) in enumerate(zip(inputs, program.in_dtypes)):
        regs[k] = npo.carrier(x.expand(n), dt)
    for op, a, b, la, lb, da, db, dst in program.instrs:
        regs[dst] = npo.apply(op, regs[a], da, regs[b], db, la, lb,
                              program.nans)
    return [npo.from_carrier(regs[r], dt).contiguous()
            for r, dt in zip(program.outputs, program.out_dtypes)]
