"""Serving entry point: continuous batching over the KV page allocator, against
the dense KV cache or (``--kv-layout paged``) the paged pool.

Every architecture of the registry serves (``--arch gemma-7b``,
``phi3-mini-3.8b``, ``internvl2-26b``, ``whisper-small``, ``xlstm-125m``,
...). The paged pool is for the dense, MoE, vlm and hybrid families; audio
and ssm raise ValueError there, as the reference has no paged decode for
them. Whisper serves from ``enc_out`` zeros: the reference's serving never
runs the encoder.

Usage (on a CUDA card unless --device names another):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen25_32b \\
      --reduced --requests 8 --max-new 32 [--kv-layout paged --page-size 16]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs import ArchConfig, get_arch, reduced_config
from repro_torch.engine.serve_step import ServingEngine
from repro_torch.models import Ctx, Model, build_model, resolve_device

__all__ = ["serve_batch", "serve_model", "main"]


def serve_batch(arch: Union[str, ArchConfig], *, n_requests: int = 8, max_new: int = 32,
                batch_size: int = 4, reduced: bool = True, seed: int = 0,
                device=None, dtype=None, layers: Optional[int] = None,
                kv_layout: str = "dense", page_size: int = 64):
    """Serve ``n_requests`` seeded random prompts greedily to completion.

    ``arch`` is a name or an ``ArchConfig``. ``device`` defaults to CUDA
    (raises without a card), ``dtype`` to the config's ``param_dtype``,
    ``layers`` to the full depth. Weights are random, drawn on the device
    from ``seed``. The rest is ``serve_model``'s."""
    dev = resolve_device(device)
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    if reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg, layers=layers)
    model.init_params(torch.Generator(dev).manual_seed(seed), dtype)
    return serve_model(model, n_requests=n_requests, max_new=max_new,
                       batch_size=batch_size, seed=seed, kv_layout=kv_layout,
                       page_size=page_size)


def serve_model(model: Model, *, n_requests: int = 8, max_new: int = 32,
                batch_size: int = 4, seed: int = 0, kv_layout: str = "dense",
                page_size: int = 64, ctx: Optional[Ctx] = None):
    """Serve ``n_requests`` prompts drawn from ``seed`` (2-7 tokens each)
    greedily to completion through a ``ServingEngine`` over ``model``
    (max_seq ``max_new + 16``; ``kv_layout`` "dense" or "paged",
    ``page_size`` tokens a page; ``ctx`` the model context, e.g. a rank's
    over a mesh, whose model holds its slices under ``param_specs``, every
    rank of the mesh serving the same requests and sampling the same
    tokens). Returns the counts, the wall time and each request's
    generated tokens in submission order."""
    eng = ServingEngine(model, batch_size=batch_size,
                        max_seq=max_new + 16, ctx=ctx, eos_id=-1,
                        page_size=page_size, kv_layout=kv_layout)
    rng = np.random.default_rng(seed)
    for _ in range(n_requests):
        prompt = rng.integers(1, model.cfg.vocab_size,
                              rng.integers(2, 8)).tolist()
        eng.submit(prompt)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    t0 = time.perf_counter()
    iters = 0
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        iters += 1
        if iters > n_requests * (max_new + 16) * 2:
            raise RuntimeError("serving did not drain")
    dt = time.perf_counter() - t0  # each step ends in a host copy: synced
    toks = sum(len(s.out) for s in eng.finished)
    return {"finished": len(eng.finished), "tokens": toks,
            "seconds": dt, "iters": iters,
            "pages_in_use": eng.pages.pages_in_use(),
            "outputs": [s.out for s in sorted(eng.finished,
                                              key=lambda s: s.sid)]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="default: cuda (fails without a card)")
    ap.add_argument("--dtype", default=None,
                    help="default: the config's param_dtype")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: all layers)")
    ap.add_argument("--kv-layout", choices=("dense", "paged"),
                    default="dense",
                    help="decode against the dense cache or the paged pool")
    ap.add_argument("--page-size", type=int, default=64,
                    help="tokens per KV page")
    args = ap.parse_args(argv)
    out = serve_batch(args.arch, n_requests=args.requests,
                      max_new=args.max_new, batch_size=args.batch,
                      reduced=args.reduced, device=args.device,
                      dtype=args.dtype, layers=args.layers,
                      kv_layout=args.kv_layout, page_size=args.page_size)
    print(f"served {out['finished']} requests, {out['tokens']} tokens in "
          f"{out['seconds']:.1f}s ({out['iters']} engine steps); "
          f"KV pages still held: {out['pages_in_use']}")


if __name__ == "__main__":
    main()
