"""Time this tree's ``moe_gather`` and ``ssm_scan`` kernels against another
tree's, on one CUDA card, in one process, at ``chip_smoke.py``'s shapes.

    PYTHONPATH=src python -m repro_torch.launch.kernel_compare \\
        --other PATH_TO_OTHER_CHECKOUT

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
takes. The bounds are ``launch/bounds.py``'s. Prints one line per case,
the card's name and power limit, and a JSON object of the numbers as the
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
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.kernels import moe_dispatch as mg
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels.ref import moe_gather_ref, ssm_scan_ref
from repro_torch.launch.bounds import gather_bound_ms, scan_bound_ms

__all__ = ["GATHER_CASES", "SCAN_CASES", "load_other", "events_ms", "turns",
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 2
    root = args.other.resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    gather = compare_gather(load_other(root, "moe_dispatch"))
    scan = compare_scan(load_other(root, "ssm_scan"))
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": smi,
                      "moe_gather": gather, "ssm_scan": scan}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
