"""Time this tree's ``moe_gather`` and ``ssm_scan`` kernels against another
tree's, and this tree's expression core (K1) over its two input paths, on
one CUDA card, in one process, at ``chip_smoke.py``'s shapes.

    PYTHONPATH=src python -m repro_torch.launch.kernel_compare \\
        [--other PATH_TO_OTHER_CHECKOUT]

``--other`` is the root of another checkout of the repository (for
example the parent commit unpacked with ``git archive``); its
``src/repro_torch/kernels/{moe_dispatch,ssm_scan}.py`` are loaded as
modules of their own and build their own sources. Each case is checked on
both kernels against the plain version (``moe_gather`` bit for bit,
``ssm_scan`` within atol=rtol=1e-5), then timed with CUDA events (the mean
of back-to-back launches) in turns: other, this, this, other, twice;
beside one PyTorch call where there is one (``index_select`` for the
gather; none computes a selective scan) and the bound (bytes for the
gather; exponentials at 16 per clock per SM, or bytes, for the scan).
``ssm_scan`` is also timed at 2 and 4 lanes a channel, whichever the plan
takes. The bounds are ``launch/bounds.py``'s. ``compare_segment`` times
both trees' ``segment_reduce`` (K2) the same way at the shape of TPC-H
Q1's first partition at scale factor 10 (14,019,887 rows in 3 groups of
Q1's sizes, in random order; 7 float64 sums and 4 int64 counts), checked
bit for bit against each other. Without ``--other`` these three are left
out.

``compare_expr_io`` (always run) times K1 at TPC-H Q1's batch (8,192
rows; 6 inputs, 5 instructions, 3 outputs: Q1's fused core) over its two
input paths from one pinned staging buffer: "mapped", the kernel reading
the pinned inputs through the card's mapping (the engine's path), and
"staged", one ``cudaMemcpyAsync`` of the buffer into device memory, then
the kernel; both write their outputs into pinned host memory. Each is
timed by CUDA events, on the device by the profiler, and per batch on
the host clock (pack, launch, wait, copy out), beside the link bound:
the batch's bytes over the host-to-device rate of a pinned copy that
``link_rates`` measures in the same run. Prints one line per case, the
card's name and power limit, and a JSON object of the numbers as the
last line.

``load_other``, ``events_ms`` and ``turns`` are shared with
``flash_compare``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.kernels import expr_core as ec
from repro_torch.kernels import moe_dispatch as mg
from repro_torch.kernels import ops
from repro_torch.kernels import segment_reduce as sr
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels.transfer import Staging
from repro_torch.kernels.ref import moe_gather_ref, ssm_scan_ref
from repro_torch.launch.bounds import gather_bound_ms, scan_bound_ms

__all__ = ["GATHER_CASES", "SCAN_CASES", "load_other", "events_ms", "turns",
           "link_rates", "q1_core", "compare_expr_io", "compare_segment",
           "main"]

# as chip_smoke.py: qwen2-moe's dispatch (T tokens of width d into S =
# 60 experts x capacity slots, n_kept filled) and jamba's scan
GATHER_CASES = [  # (name, T, d, S, n_kept, dtype)
    ("prefill", 4096, 2048, 60 * 344, 4 * 4096, "bfloat16"),
    ("decode", 4, 2048, 60 * 8, 16, "bfloat16"),
    ("ragged_f32", 100, 48, 333, 250, "float32"),
]
SCAN_CASES = [  # (name, Bt, L, di, N)
    ("prefill", 1, 4096, 16384, 16),
    ("ragged", 2, 1001, 3000, 16),
]
SCAN_TOL = 1e-5
GATHER_REPS, SCAN_REPS, ROUNDS = 50, 20, 2
EXPR_ROWS, EXPR_REPS = 8192, 200  # the executor's batch
Q1_GROUPS = (3_507_138, 7_006_400, 3_506_349)  # Q1's first partition
SEGMENT_REPS = 3
LINK_BYTES = 256 << 20


def load_other(root: Path, module: str):
    """``src/repro_torch/kernels/<module>.py`` of the checkout at ``root``,
    loaded as a module of its own (it imports this tree's ``nvcc``)."""
    path = root / "src" / "repro_torch" / "kernels" / f"{module}.py"
    spec = importlib.util.spec_from_file_location(f"other_{module}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def events_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean device time of fn over reps back-to-back calls, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def turns(fns: Dict[str, Callable[[], object]], order: Sequence[str],
          reps: int, rounds: int = ROUNDS) -> Dict[str, List[float]]:
    """``events_ms`` of each named function, in ``order`` (e.g. other,
    this, this, other), ``rounds`` times: {name: [ms, ...]}."""
    times: Dict[str, List[float]] = {who: [] for who in fns}
    for _ in range(rounds):
        for who in order:
            times[who].append(events_ms(fns[who], reps))
    return times


def _gather_case(rng, T, d, S, n_kept, dtype):
    x = torch.from_numpy(rng.standard_normal(
        (T, d), dtype=np.float32)).to("cuda", getattr(torch, dtype))
    slots = rng.choice(S, n_kept, replace=False)
    ids_np = np.full(S, -1, np.int32)
    ids_np[slots] = rng.permutation(np.resize(np.arange(T), n_kept))
    ids = torch.from_numpy(ids_np).to("cuda")
    return x, ids, ids >= 0, len(np.unique(ids_np[slots]))


def compare_gather(other) -> dict:
    rng = np.random.default_rng(0)
    results = {}
    for name, T, d, S, n_kept, dtype in GATHER_CASES:
        x, ids, keep, rows = _gather_case(rng, T, d, S, n_kept, dtype)
        want = moe_gather_ref(x, ids, keep)
        view = torch.int16 if x.element_size() == 2 else torch.int32
        for who, mod in (("this", mg), ("other", other)):
            if not torch.equal(mod.moe_gather(x, ids, keep).view(view),
                               want.view(view)):
                raise AssertionError(f"gather {name}: {who} kernel not "
                                     f"bit-equal to the plain version")
        lib_ids = ids.clamp(min=0)
        times = turns({"other": lambda: other.moe_gather(x, ids, keep),
                       "this": lambda: mg.moe_gather(x, ids, keep)},
                      ["other", "this", "this", "other"], GATHER_REPS)
        lib = events_ms(lambda: torch.index_select(x, 0, lib_ids),
                        GATHER_REPS)
        bound, by = gather_bound_ms(rows, d, S, x.element_size())
        results[name] = {"shape": [T, d, S, n_kept, dtype],
                         "this_ms": times["this"],
                         "other_ms": times["other"], "index_select_ms": lib,
                         "bound_ms": bound, "bound_by": by}
        print(f"[kernel_compare] moe_gather {name}: T={T} d={d} S={S} kept "
              f"{n_kept} {dtype}: this {times['this']} ms, "
              f"other {times['other']} ms, index_select {lib:.4f} ms, "
              f"bound {bound:.4f} ms by {by} (this at "
              f"{bound / min(times['this']):.1%} of it)", flush=True)
        del x, ids, keep, want, lib_ids
    return results


def compare_scan(other) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    results = {}
    for name, Bt, L, di, N in SCAN_CASES:
        def mk(*shape):
            return torch.randn(shape, device="cuda", generator=gen)

        dt = torch.nn.functional.softplus(mk(Bt, L, di)) * 0.1
        A = -torch.exp(mk(di, N) * 0.3)
        B, C, x = mk(Bt, L, N), mk(Bt, L, N), mk(Bt, L, di)
        want = ssm_scan_ref(dt, A, B, C, x)
        fns = {"other": lambda: other.ssm_scan(dt, A, B, C, x),
               "this": lambda: ss.ssm_scan(dt, A, B, C, x),
               "this_2_lanes": lambda: ss._scan(dt, A, B, C, x, 2),
               "this_4_lanes": lambda: ss._scan(dt, A, B, C, x, 4)}
        errs = {}
        for who, fn in fns.items():
            diff = (fn() - want).abs()
            errs[who] = float(diff.max())
            if bool((diff > SCAN_TOL + SCAN_TOL * want.abs()).any()):
                raise AssertionError(f"scan {name}: {who} kernel off by "
                                     f"{errs[who]:.3g}")
        times = turns(fns, ["other", "this", "this_2_lanes", "this_4_lanes",
                            "this", "other"], SCAN_REPS)
        bound, by = scan_bound_ms(Bt, L, di, N)
        results[name] = {"shape": [Bt, L, di, N], "bound_ms": bound,
                         "bound_by": by, "max_abs_err": errs,
                         **{f"{who}_ms": t for who, t in times.items()}}
        lanes = ss.plan(Bt, di).lanes
        print(f"[kernel_compare] ssm_scan {name}: Bt={Bt} L={L} di={di} "
              f"N={N}: this ({lanes} lanes) {times['this']} ms, at 2 lanes "
              f"{times['this_2_lanes']} ms, at 4 lanes "
              f"{times['this_4_lanes']} ms, other {times['other']} ms, no "
              f"library call, bound {bound:.4f} ms by {by} (this at "
              f"{bound / min(times['this']):.1%} of it); max|err| {errs}",
              flush=True)
        del dt, A, B, C, x, want
        torch.cuda.empty_cache()
    return results


def compare_segment(other) -> dict:
    """K2 of this tree and of ``other`` at Q1's first partition's shape
    (see the module's note), in turns other, this, this, other."""
    rng = np.random.default_rng(0)
    inv = rng.permutation(np.repeat(np.arange(len(Q1_GROUPS)), Q1_GROUPS))
    rows = inv.shape[0]
    dev = torch.device("cuda", torch.cuda.current_device())
    vals = [torch.from_numpy(rng.uniform(1.0, 1e5, rows).round(2)).to(dev)
            for _ in range(7)]
    vals += [torch.ones(rows, dtype=torch.int64, device=dev)
             for _ in range(4)]
    dts = [np.dtype(np.float64)] * 7 + [np.dtype(np.int64)] * 4
    combs = ["sum"] * len(vals)
    inv = torch.from_numpy(inv).to(dev)
    args = (inv, len(Q1_GROUPS), vals, dts, combs)
    for a, b in zip(sr.segment_reduce(*args), other.segment_reduce(*args)):
        if not torch.equal(a.view(torch.int64), b.view(torch.int64)):
            raise AssertionError("segment_reduce: this and the other tree "
                                 "disagree")
    times = turns({"other": lambda: other.segment_reduce(*args),
                   "this": lambda: sr.segment_reduce(*args)},
                  ["other", "this", "this", "other"], SEGMENT_REPS)
    print(f"[kernel_compare] segment_reduce at Q1's first partition "
          f"({rows:,} rows, groups of {list(Q1_GROUPS)}, {len(vals)} "
          f"columns): this {times['this']} ms, other {times['other']} ms",
          flush=True)
    del inv, vals
    torch.cuda.empty_cache()
    return {"rows": rows, "groups": list(Q1_GROUPS), "this_ms":
            times["this"], "other_ms": times["other"]}


def link_rates() -> Dict[str, float]:
    """Bytes/s of one LINK_BYTES copy from pinned host memory to the card
    and back, by CUDA events (the mean of 5 after a warm-up)."""
    host = torch.empty(LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(LINK_BYTES, dtype=torch.uint8, device="cuda")
    rates = {
        "h2d": LINK_BYTES / (1e-3 * events_ms(
            lambda: dev.copy_(host, non_blocking=True), 5)),
        "d2h": LINK_BYTES / (1e-3 * events_ms(
            lambda: host.copy_(dev, non_blocking=True), 5))}
    del host, dev
    return rates


def q1_core(rng, n: int = EXPR_ROWS):
    """Q1's fused core and a batch of its inputs: ``shipdate <= 9400``
    and the two derived prices, ``price * (1 - discount)`` and that times
    ``1 + tax`` (the constants one value each)."""
    price = rng.uniform(900.0, 105_000.0, n).round(2)
    discount = rng.integers(0, 11, n) / 100.0
    tax = rng.integers(0, 9, n) / 100.0
    shipdate = rng.integers(8000, 10_600, n).astype(np.int32)
    one, cutoff = np.array([1]), np.array([9400])
    f8, i8 = np.dtype(np.float64), np.dtype(np.int64)
    dtypes = {0: f8, 1: f8, 2: f8, 3: np.dtype(np.int32), 4: i8, 5: i8,
              6: f8, 7: f8, 8: f8, 9: f8, 10: np.dtype(bool)}
    program = ec.encode([("-", 6, (4, 1)), ("*", 7, (0, 6)),
                         ("+", 8, (4, 2)), ("*", 9, (7, 8)),
                         ("<=", 10, (3, 5))], dtypes, [0, 1, 2, 3, 4, 5],
                        [7, 9, 10])
    return program, [price, discount, tax, shipdate, one, cutoff]


def _profiled_ms(fn: Callable[[], object], reps: int,
                 matches: Sequence[str]) -> float:
    """Device time per call of fn of the kernels and copies whose name
    holds one of ``matches``, over reps calls under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0.0)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and any(m in e.key for m in matches))
    return total / 1e3 / reps


def compare_expr_io(program=None, arrays=None, n: int = EXPR_ROWS,
                    rates: Dict[str, float] = None) -> dict:
    """K1's two input paths (see the module's note) at one batch:
    ``program`` over ``arrays`` (numpy; a constant as one value), Q1's
    core on random inputs when not given. Both are checked against the
    plain version first."""
    if program is None:
        program, arrays = q1_core(np.random.default_rng(0), n)
    rates = rates or link_rates()
    dev = torch.device("cuda", torch.cuda.current_device())
    ins_stage, outs_stage = Staging(), Staging()
    specs = [(n, dt) for dt in program.out_dtypes]
    ins, total = ins_stage.pack([[a] for a in arrays])
    outs = outs_stage.views(specs)
    dev_buf = torch.empty(total, dtype=torch.uint8, device=dev)
    base = ins_stage.buf.data_ptr()
    dev_ins = [dev_buf[x.data_ptr() - base:x.data_ptr() - base + x.nbytes]
               .view(x.dtype) for x in ins]
    want = ec.expr_core_ref(program, [x.clone() for x in ins], n)

    def mapped():
        ops.expr_core(program, ins, n, outs=outs, device=dev)

    def staged():
        dev_buf.copy_(ins_stage.buf[:total], non_blocking=True)
        ops.expr_core(program, dev_ins, n, outs=outs, device=dev)

    def per_batch(fn):  # the engine's per-batch path on the host clock
        def run():
            ins_stage.pack([[a] for a in arrays])
            fn()
            torch.cuda.current_stream(dev).synchronize()
            return [o.numpy().copy() for o in outs]
        run()
        t0 = time.perf_counter()
        for _ in range(EXPR_REPS):
            run()
        return 1e3 * (time.perf_counter() - t0) / EXPR_REPS

    nbytes = sum(x.nbytes for x in ins) + sum(o.nbytes for o in outs)
    results = {"rows": n, "inputs": len(arrays),
               "instructions": len(program.instrs),
               "outputs": len(program.out_dtypes), "bytes": nbytes,
               "link_h2d_bytes_per_s": rates["h2d"],
               "link_d2h_bytes_per_s": rates["d2h"],
               "link_bound_ms": 1e3 * nbytes / rates["h2d"]}
    for name, fn, matches in (("mapped", mapped, ("expr_core",)),
                              ("staged", staged, ("expr_core", "emcpy"))):
        fn()
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            if o.numpy().tobytes() != w.numpy().tobytes():
                raise AssertionError(f"expr_core {name}: not the plain "
                                     f"version's bytes")
        results[name] = {
            "events_ms": events_ms(fn, EXPR_REPS),
            "device_ms": _profiled_ms(fn, EXPR_REPS, matches),
            "per_batch_host_ms": per_batch(fn)}
    print(f"[kernel_compare] expr_core at {n} rows ({len(arrays)} inputs, "
          f"{len(program.instrs)} instructions, {len(program.out_dtypes)} "
          f"outputs, {nbytes:,} bytes): mapped {results['mapped']} ms, "
          f"staged {results['staged']} ms; link bound "
          f"{results['link_bound_ms']:.4f} ms at "
          f"{rates['h2d'] / 1e9:.2f} GB/s host to device "
          f"({rates['d2h'] / 1e9:.2f} GB/s back)", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "card": smi,
           "expr_core_io": compare_expr_io()}
    if args.other is not None:
        root = args.other.resolve()
        out["moe_gather"] = compare_gather(load_other(root, "moe_dispatch"))
        out["ssm_scan"] = compare_scan(load_other(root, "ssm_scan"))
        out["segment_reduce"] = compare_segment(
            load_other(root, "segment_reduce"))
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
