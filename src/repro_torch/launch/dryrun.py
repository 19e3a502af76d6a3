"""The dry-run's planning half (port of ``repro.launch.dryrun``): for every
(architecture x input shape) cell on the production meshes, the sharding
plan and each device's persistent state, with no mesh and no device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh single,multi --out artifacts/dryrun_torch

Each cell's record has the reference record's keys that do not come from
a compiler: ``arch``, ``shape``, ``mesh``, ``status`` (``skipped`` with
``cell_is_runnable``'s reason), ``devices``, ``kind``, ``params``,
``plan`` and ``analytic_state_bytes_per_device`` (parameters, plus the
AdamW moments for train, plus the decode state for decode, each leaf
divided by the product of the mesh axes its spec names). The reference's
other keys (``lower_s``, ``compile_s``, ``flops_per_device``,
``bytes_accessed_per_device``, ``memory_analysis``, ``collectives``,
``collective_moved_bytes_per_device``) are XLA's analyses of the program
it lowers and compiles for the mesh; the port has no such compiler, so it
leaves them out (ROADMAP.md, queue 1, item 13).

The meshes are the production ones: 16 x 16 ("data", "model") and
2 x 16 x 16 ("pod", "data", "model").
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Any, Dict, Optional

from repro_torch import tree as tr
from repro_torch.configs import (ARCH_IDS, SHAPES, cell_is_runnable, get_arch,
                                 get_shape)
from repro_torch.core.planner import P, make_plan
from repro_torch.engine.specs import abstract_decode_state
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, abstract_opt_state, opt_state_specs

__all__ = ["mesh_axes_for", "analytic_bytes_per_device", "run_cell", "main"]


def mesh_axes_for(mesh_kind: str) -> Dict[str, int]:
    """The production mesh's axis sizes for ``mesh_kind``, "single" or
    "multi"."""
    if mesh_kind == "single":
        return {"data": 16, "model": 16}
    if mesh_kind == "multi":
        return {"pod": 2, "data": 16, "model": 16}
    raise ValueError(f"mesh {mesh_kind!r}: 'single' or 'multi'")


def _shard_factor(spec: P, axis_sizes: Dict[str, int]) -> int:
    f = 1
    for entry in spec:
        if entry is None:
            continue
        for a in entry if isinstance(entry, tuple) else (entry,):
            f *= axis_sizes.get(a, 1)
    return f


def analytic_bytes_per_device(abstract_tree, spec_tree,
                              axis_sizes: Dict[str, int]) -> int:
    """Sum over the leaves of each leaf's bytes over its shard factor."""
    total = 0
    for a, s in zip(tr.leaves(abstract_tree), tr.leaves(spec_tree)):
        total += (a.numel() * a.element_size()) // max(
            1, _shard_factor(s, axis_sizes))
    return total


def run_cell(arch_name: str, shape_name: str, mesh_kind: str,
             out_dir: Optional[str] = None) -> Dict[str, Any]:
    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    ok, why = cell_is_runnable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch_name, "shape": shape_name,
                           "mesh": mesh_kind}
    if not ok:
        rec.update({"status": "skipped", "reason": why})
        return rec
    axes = mesh_axes_for(mesh_kind)
    plan = make_plan(cfg, axes, shape)
    model = build_model(cfg)
    p_abs = model.abstract_params()
    p_spec = model.param_specs(plan)
    state_bytes = analytic_bytes_per_device(p_abs, p_spec, axes)
    if shape.kind == "train":
        o_abs = abstract_opt_state(p_abs, AdamWConfig(
            moment_dtype=cfg.moment_dtype))
        state_bytes += analytic_bytes_per_device(
            o_abs, opt_state_specs(p_spec), axes)
    elif shape.kind == "decode":
        state_bytes += analytic_bytes_per_device(
            abstract_decode_state(model, shape),
            model.decode_state_specs(plan), axes)
    rec.update({
        "status": "ok",
        "devices": math.prod(axes.values()),
        "kind": shape.kind,
        "analytic_state_bytes_per_device": state_bytes,
        "plan": {"moe": plan.moe_strategy, "kv": plan.kv_strategy,
                 "fsdp": plan.fsdp, "remat": plan.remat,
                 "shard_batch": plan.shard_batch,
                 "decisions": plan.decisions},
        "params": model.param_count(),
    })
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch_name}__{shape_name}__{mesh_kind}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    for mk in args.mesh.split(","):
        for a in archs:
            for s in shapes:
                rec = run_cell(a, s, mk, out_dir=args.out)
                if rec["status"] == "ok":
                    print(f"[OK]   {a:18s} {s:12s} {mk:6s} "
                          f"state/dev={rec['analytic_state_bytes_per_device']/2**30:.2f}GiB "
                          f"plan={rec['plan']['moe']}/{rec['plan']['kv']}"
                          f"/fsdp={rec['plan']['fsdp']}", flush=True)
                else:
                    print(f"[SKIP] {a:18s} {s:12s} {mk:6s} {rec['reason']}",
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
