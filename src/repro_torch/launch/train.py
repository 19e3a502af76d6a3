"""Training entry point (port of ``repro.launch.train``): data pages -> the
supervised train loop with atomic checkpointing, restart recovery and
heartbeat-based straggler checks.

Runs eagerly on one device: the card unless ``device`` names another
(raises without a card and without a device named). ``layers`` cuts the
depth only, never a width. Every MoE layer's dispatch goes through the
``moe_gather`` kernel and its backward kernel on the card, every Mamba
layer's scan through ``ssm_scan`` and its backward; attention runs on the
plain path (``Ctx()``, as the reference trains).

Over a mesh (``mesh=``, a ``launch.mesh.Mesh``; one process a rank, each
calling ``train_loop`` alike) the loop plans for the mesh, each rank draws
its slices of the very weights one process draws (``Model.init_shards``)
or takes them from ``weights``, draws the same global batch from the same
loader and keeps its data shard (``engine.train_step.shard_batch``), and
steps under ``Ctx(plan=, mesh=)``: the losses are the single process's.
Checkpoints hold whole leaves, as one process writes them, and a job
restarted on another mesh restores its slices from them. A config that
sets ``fsdp`` (every published one but phi3-mini, whisper-small and
xlstm-125m) trains at its FSDP plan, its leaves over the data axis too,
and every layer is rematerialized as ``cfg.remat`` says.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_moe \\
      --layers 4 --steps 5 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_moe \\
      --reduced --device cpu --steps 5 --batch 4 --seq 64
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Mapping, Optional, Union

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import (ArchConfig, ShapeConfig, get_arch,
                                 reduced_config)
from repro_torch.core.planner import make_plan
from repro_torch.data import TokenLoader, TokenPageWriter
from repro_torch.data.synthetic import lm_tokens
from repro_torch.distributed import HeartbeatMonitor, Supervisor
from repro_torch.distributed.elastic import reshard_state
from repro_torch.engine.train_step import (TrainConfig, make_train_step,
                                           shard_batch)
from repro_torch.models import Ctx, build_model, resolve_device
from repro_torch.models.params import flatten, torch_dtype
from repro_torch.objectmodel import PagedStore
from repro_torch.optim import (AdamWConfig, init_opt_state, opt_state_specs,
                               warmup_cosine)

__all__ = ["train_loop", "main"]


def train_loop(arch: Union[str, ArchConfig], *, steps: int, batch: int,
               seq: int, ckpt_dir: Optional[str] = None,
               reduced: bool = True, save_every: int = 20,
               microbatches: int = 1, lr: float = 3e-4, seed: int = 0,
               log_every: int = 10, fail_at: Optional[int] = None,
               dtype: str = "float32", device=None,
               layers: Optional[int] = None,
               records: Optional[int] = None,
               weights: Optional[Mapping[str, torch.Tensor]] = None,
               mesh=None) -> Dict[str, Any]:
    """Train ``arch`` (a name or an ``ArchConfig``) for ``steps`` steps of
    ``batch`` sequences of ``seq + 1`` tokens. Weights are random, drawn
    on the device from ``seed``, or a copy of ``weights`` (a state_dict of
    the model's, e.g. ``Model.state_dict()``) on the device in ``dtype``:
    two devices draw different numbers from one seed, so a run on the card
    and one on the CPU start from the same state through ``weights``. The
    tokens are ``lm_tokens`` rows, as the reference's: ``records`` of them
    (default max(64, 8 x batch)), so ``records == batch`` repeats one
    batch every step. ``mesh``: this rank's mesh (the module's "Over a
    mesh"; the device is then the mesh's). Returns the
    reference's dict (losses, params, opt, report, seconds,
    straggler_plan) plus ``history``, one dict a step: loss (the total
    loss), grad_norm, lr and the step's wall seconds, taken after the
    host has read the step's loss (so the device's work is done)."""
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    if reduced:
        cfg = reduced_config(cfg)
    dev = mesh.device if mesh is not None else resolve_device(device)
    model = build_model(cfg, layers)
    cfg = model.cfg
    ctx, specs = Ctx(), None
    if mesh is not None:
        plan = make_plan(cfg, mesh.shape,
                         ShapeConfig("train", seq, batch, "train"))
        ctx = Ctx(plan=plan, mesh=mesh, ep_shard_map=True)
        specs = model.param_specs(plan)
    if weights is None and mesh is None:
        model.init_params(torch.Generator(dev).manual_seed(seed), dtype,
                          trainable=True)
    elif weights is None:
        model.init_shards(torch.Generator(dev).manual_seed(seed), plan,
                          mesh, dtype).requires_grad_(True)
    else:
        dt = torch_dtype(dtype)
        if mesh is None:
            model.load_state_dict({k: v.detach().to(dev, dt, copy=True)
                                   for k, v in weights.items()}, assign=True)
        else:  # each leaf's slice, then onto the rank's device
            model.load_shards(reshard_state(
                {k: v.detach().to(dtype=dt) for k, v in weights.items()},
                flatten(specs), mesh))
        model.requires_grad_(True)
    params = model.params()
    ocfg = AdamWConfig(moment_dtype="float32")
    opt = init_opt_state(params, ocfg)
    tcfg = TrainConfig(microbatches=microbatches, opt=ocfg)
    lr_fn = warmup_cosine(lr, max(1, steps // 20), steps)
    step_fn = make_train_step(model, ctx, tcfg, lr_fn)
    talk = mesh is None or mesh.rank == 0

    # --- data: synthetic tokens through the zero-copy page pipeline
    store = PagedStore()
    w = TokenPageWriter(store, "train", seq)
    toks = lm_tokens(records or max(64, batch * 8), seq, cfg.vocab_size,
                     seed)
    for row in toks:
        w.add_document(row.tolist())
    loader = TokenLoader(w.set, batch, seed=seed)
    data = {"batches": _cycle(loader)}

    def restore_data(extra: Dict) -> None:
        """Back to the checkpoint's cursor, in a new iteration from it (the
        reference's loop keeps drawing from the iteration in flight, so its
        replayed steps see later batches)."""
        loader.restore(extra.get("data", loader.state()))
        data["batches"].close()
        data["batches"] = _cycle(loader)
    extra = _extra_inputs(cfg, batch // ctx.dp, dtype, dev)

    monitor = HeartbeatMonitor(n_workers=1)
    losses, history = [], []
    t_start = time.time()

    fired = {"crash": False}

    def one_step(state, step):
        params, opt = state
        if fail_at is not None and step == fail_at and not fired["crash"]:
            fired["crash"] = True  # one-shot: node comes back after re-fork
            raise RuntimeError("injected worker failure")  # tests
        b = next(data["batches"])
        t0 = time.perf_counter()
        tb = {k: t.to(dev) for k, t in shard_batch(
            {k: torch.from_numpy(v) for k, v in b.items()}, ctx,
            microbatches).items()}
        tb.update(extra)
        params, opt, _, metrics = step_fn(params, opt, None, tb)
        loss = float(metrics["total_loss"])
        seconds = time.perf_counter() - t0
        monitor.beat(0, seconds)
        losses.append(loss)
        history.append({"step": step, "loss": loss,
                        "grad_norm": float(metrics["grad_norm"]),
                        "lr": float(metrics["lr"]), "seconds": seconds})
        if step % log_every == 0 and talk:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {history[-1]['lr']:.2e} "
                  f"gnorm {history[-1]['grad_norm']:.3f}", flush=True)
        return params, opt

    state = (params, opt)
    report = None
    if ckpt_dir:
        sup = Supervisor(Checkpointer(ckpt_dir), save_every=save_every,
                         specs=None if mesh is None else (
                             specs, opt_state_specs(specs)),
                         mesh=mesh)
        state, report = sup.run(
            state, one_step, steps,
            extra_fn=lambda: {"data": loader.state()},
            restore_extra=restore_data)
    else:
        for s in range(steps):
            state = one_step(state, s)
    return {"losses": losses, "params": state[0], "opt": state[1],
            "report": report, "seconds": time.time() - t_start,
            "straggler_plan": monitor.check(), "history": history}


def _extra_inputs(cfg: ArchConfig, batch: int, dtype: str,
                  device) -> Dict[str, torch.Tensor]:
    """Whisper's stub encoder frames and the vlm's patch embeddings,
    zeros as the reference's."""
    dt = torch_dtype(dtype)
    out = {}
    if cfg.family == "audio":
        out["frames"] = torch.zeros((batch, cfg.encoder_len, cfg.d_model),
                                    dtype=dt, device=device)
    if cfg.family == "vlm":
        out["patches"] = torch.zeros((batch, cfg.n_patches, cfg.d_model),
                                     dtype=dt, device=device)
    return out


def _cycle(loader):
    while True:
        n = 0
        for b in loader:
            n += 1
            yield b
        if n == 0:
            raise RuntimeError("empty loader")
        loader.shard.cursor = 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (never a width)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--records", type=int, default=None,
                    help="token records drawn (default max(64, 8 x batch))")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    args = ap.parse_args(argv)
    out = train_loop(args.arch, steps=args.steps, batch=args.batch,
                     seq=args.seq, ckpt_dir=args.ckpt_dir,
                     reduced=args.reduced, save_every=args.save_every,
                     microbatches=args.microbatches, lr=args.lr,
                     device=args.device, layers=args.layers,
                     records=args.records)
    print(f"final loss {out['losses'][-1]:.4f} "
          f"({out['seconds']:.1f}s, {len(out['losses'])} steps)")
    print("per step: " + "; ".join(
        f"{h['step']}: loss {h['loss']:.4f}, {h['seconds'] * 1e3:.1f} ms"
        for h in out["history"]))


if __name__ == "__main__":
    main()
