"""Time training steps of this tree against another tree's on one CUDA
card, in turns: other, this, this, other.

    PYTHONPATH=src python -m repro_torch.launch.train_compare \\
        --other PATH_TO_OTHER_CHECKOUT

``--other`` is the root of another checkout of the repository (for
example the parent commit unpacked with ``git archive``). Each turn is one
process, ``python -m repro_torch.launch.train``, started from its tree's
root with that tree's ``src`` on the path, so each tree builds and runs
its own kernels. The run is ``chip_smoke.py``'s phase 18a (``RUN``):
qwen2-moe-a2.7b at every published width cut to 4 of its 24 layers,
B=4 x 1,025 tokens, one repeated batch, 5 steps at lr 3e-5. Prints each
turn's per-step times and losses (the CLI's ``per step:`` line), each
tree's steps after the first (least, median, most), the card's name and
power limit, and a JSON object of the numbers as the last line.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[3]
RUN = ["--arch", "qwen2_moe", "--layers", "4", "--steps", "5", "--batch",
       "4", "--seq", "1024", "--records", "4", "--lr", "3e-5"]
STEP = re.compile(r"(\d+): loss ([-\d.naif]+), ([\d.]+) ms")


def run_tree(root: Path) -> List[dict]:
    """One training run of the tree at ``root``: [{step, loss, ms}]."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *RUN]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: exit {out.returncode}\n"
                           f"{out.stderr[-4000:]}")
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("per step: "))
    return [{"step": int(s), "loss": float(loss), "ms": float(ms)}
            for s, loss, ms in STEP.findall(line)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    trees = {"other": args.other.resolve(), "this": ROOT}
    turns: List[Dict] = []
    for name in ("other", "this", "this", "other"):
        steps = run_tree(trees[name])
        turns.append({"tree": name, "steps": steps})
        print(f"{name}: " + "; ".join(
            f"step {s['step']} {s['ms']:.1f} ms, loss {s['loss']:.4f}"
            for s in steps), flush=True)
    summary = {}
    for name in ("other", "this"):
        ms = [s["ms"] for t in turns if t["tree"] == name
              for s in t["steps"] if s["step"] > 0]
        summary[name] = {"min": min(ms), "median": statistics.median(ms),
                         "max": max(ms)}
        print(f"{name} ({trees[name]}): steps after the first "
              f"{summary[name]['min']:.1f} / {summary[name]['median']:.1f}"
              f" / {summary[name]['max']:.1f} ms (least / median / most) "
              f"over {len(ms)} steps", flush=True)
    print(smi)
    print(json.dumps({"turns": turns, "summary": summary, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
