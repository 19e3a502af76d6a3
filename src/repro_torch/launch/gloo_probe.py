"""Which collectives a gloo group carries on tensors of one device type.

    PYTHONPATH=src python -m repro_torch.launch.gloo_probe [--device cuda]

Each collective of ``PROBES`` runs on its own in two fresh rank processes
(a gloo group over a ``FileStore`` in a temporary directory, both ranks on
``--device``, on CUDA both on card 0 as the ranks of
``chip_smoke.py``'s expert-parallel phase share it) on the raw
``torch.distributed`` call, with no staging through host memory, and its
result is checked against the value it must give. A collective that gloo
does not take on such tensors may raise, kill its process or leave the
other rank waiting, so the pairs, all started at once, are waited for at
most ``--wall-s`` seconds and killed then. Prints one line a collective:
its outcome (``ok``; ``wrong``, a rank's values not the ones it must
give; ``raised``, a Python exception; ``died``, a rank ended by a signal
or the runtime; ``hung``, still running at the wall), each rank's exit
code and last lines of output; then a JSON object of the outcomes as the
last line. It is the check behind ``distributed.collectives``, which
stages through host memory only what gloo refuses on a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parents[2]
WORLD = 2
WRONG = 3  # a rank's exit code when its values are not the ones wanted
PROBES = ["all_reduce", "all_reduce_bf16", "broadcast",
          "reduce_scatter_tensor", "all_gather_into_tensor",
          "all_to_all_single", "all_to_all_single_uneven",
          "batch_isend_irecv"]


def run_probe(name: str, rank: int, dev: torch.device) -> tuple:
    """Rank ``rank``'s side of collective ``name``: (got, want) lists."""
    import torch.distributed as dist
    other = 1 - rank
    if name in ("all_reduce", "all_reduce_bf16"):
        dt = torch.bfloat16 if name.endswith("bf16") else torch.float32
        t = torch.full((4,), rank + 1.0, dtype=dt, device=dev)
        dist.all_reduce(t)
        return t, [3.0] * 4
    if name == "broadcast":
        t = torch.full((4,), float(rank + 5), device=dev)
        dist.broadcast(t, 0)
        return t, [5.0] * 4
    if name == "reduce_scatter_tensor":
        src = torch.arange(4.0, device=dev) + 10 * rank
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, src)
        return out, [2.0 * (2 * rank) + 10, 2.0 * (2 * rank + 1) + 10]
    if name == "all_gather_into_tensor":
        out = torch.empty(4, device=dev)
        dist.all_gather_into_tensor(out, torch.full((2,), float(rank),
                                                    device=dev))
        return out, [0.0, 0.0, 1.0, 1.0]
    if name == "all_to_all_single":
        src = torch.tensor([10.0 * rank, 10.0 * rank + 1], device=dev)
        out = torch.empty(2, device=dev)
        dist.all_to_all_single(out, src)
        return out, [float(rank), 10.0 + rank]
    if name == "all_to_all_single_uneven":  # split sizes, as inner_halves
        src = torch.tensor([10.0 * rank, 10.0 * rank + 1, 10.0 * rank + 2],
                           device=dev)
        out = torch.empty(3, device=dev)
        splits = [1, 2] if rank == 0 else [2, 1]
        dist.all_to_all_single(out, src, splits, splits)
        return out, [0.0, 10.0, 11.0] if rank == 0 else [1.0, 2.0, 12.0]
    if name == "batch_isend_irecv":
        src = torch.full((4,), float(rank), device=dev)
        out = torch.empty(4, device=dev)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, src, other),
                dist.P2POp(dist.irecv, out, other)]):
            req.wait()
        return out, [float(other)] * 4
    raise ValueError(f"no probe {name!r}")


def rank_main(name: str, rank: int, device: str, store: str,
              wall_s: float) -> int:
    import datetime

    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=wall_s))
    got, want = run_probe(name, rank, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    got = got.float().cpu().tolist()
    print(json.dumps({"got": got, "want": want}), flush=True)
    dist.destroy_process_group()
    return 0 if got == want else WRONG


def start(name: str, device: str, wall_s: float, where: Path) -> list:
    """Collective ``name``'s WORLD fresh rank processes, started."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), *filter(None, [os.environ.get("PYTHONPATH")])]),
        OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        with open(where / f"{name}.rank{r}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.gloo_probe",
                 "--rank", str(r), "--collective", name, "--device", device,
                 "--store", str(where / f"{name}.store"),
                 "--wall-s", str(wall_s)],
                stdout=f, stderr=subprocess.STDOUT, env=env))
    return procs


def outcome(name: str, procs: list, where: Path) -> dict:
    """What collective ``name``'s processes did, once each has exited or
    been killed."""
    last = []
    for r in range(WORLD):
        lines = [ln for ln in (where / f"{name}.rank{r}.log").read_text(
            errors="replace").splitlines() if ln.strip()]
        last.append(" | ".join(ln[:160] for ln in lines[-2:]))
    codes = [p.returncode for p in procs]
    ended = [c for p, c in zip(procs, codes) if not getattr(p, "hung", 0)]
    out = {"collective": name, "codes": codes, "last": last}
    if any(c not in (0, 1, WRONG) for c in ended):
        out["outcome"] = "died"
    elif 1 in ended:
        out["outcome"] = "raised"
    elif len(ended) < WORLD:
        out["outcome"] = "hung"
    elif WRONG in ended:
        out["outcome"] = "wrong"
    else:
        out["outcome"] = "ok"
    return out


def probe_all(device: str, wall_s: float, where: Path) -> list:
    """Every collective of PROBES, each in its own processes, all at once;
    a process still running after ``wall_s`` is killed (``hung``)."""
    running = {name: start(name, device, wall_s, where) for name in PROBES}
    deadline = time.monotonic() + wall_s
    for procs in running.values():
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.hung = True
                p.kill()
                p.wait()
    return [outcome(name, procs, where) for name, procs in running.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--wall-s", type=float, default=60.0)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--collective", help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args.collective, args.rank, args.device, args.store,
                         args.wall_s)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 1
    print(f"gloo on {args.device} tensors, {WORLD} ranks, torch "
          f"{torch.__version__}", flush=True)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="gloo_probe_") as where:
        results = probe_all(args.device, args.wall_s, Path(where))
    for res in results:
        print(f"{res['collective']}: {res['outcome']}, exit codes "
              f"{res['codes']}, last lines {res['last']}")
    print(f"{len(results)} collectives in {time.monotonic() - t0:.1f} s")
    print(json.dumps({r["collective"]: r["outcome"] for r in results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
