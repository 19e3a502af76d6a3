"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro.engine.pipeline_parallel``).

Each rank of the ``pipe`` axis holds one stage; microbatches stream
through on the reference's tick schedule: at tick t rank 0 takes
microbatch t (while there is one), every rank runs its stage on its
buffer, the last rank keeps microbatch t - (n - 1), and each rank's
output moves one rank along the ring (the reference's ``ppermute``;
``distributed.collectives.ring_shift``, one ``batch_isend_irecv`` pair a
tick, so no ring of blocking sends deadlocks). At the end the last
rank's outputs are broadcast to every rank (the reference's masked
``psum``). The bubble is the standard (n - 1) / (n_micro + n - 1).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import tree as tr
from repro_torch.distributed import collectives as coll

__all__ = ["pipeline_forward", "pipeline_loss"]


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, x: torch.Tensor, n_micro: int,
                     mesh, axis: str = "pipe") -> torch.Tensor:
    """Run x through all pipeline stages; every rank returns the output.

    stage_params: a tree whose leaves have a leading dim of the axis's
    size (every stage's; the rank takes its own); x: (B, ...) the whole
    batch, the same on every rank, split into ``n_micro`` microbatches."""
    n = mesh.shape[axis]
    rank = mesh.index(axis)
    group = mesh.group(axis)
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} is not {n_micro} microbatches")
    p = tr.tree_map(lambda a: a[rank], stage_params)
    micro = x.reshape(n_micro, -1, *x.shape[1:])
    buf = torch.zeros_like(micro[0])
    outs = torch.zeros_like(micro)
    for t in range(n_micro + n - 1):
        if rank == 0 and t < n_micro:
            buf = micro[t]
        y = stage_fn(p, buf)
        emit = t - (n - 1)
        if rank == n - 1 and 0 <= emit < n_micro:
            outs[emit] = y
        buf = coll.ring_shift(y, group)
    coll.broadcast(outs, n - 1, group)
    return outs.reshape(-1, *x.shape[1:])


def pipeline_loss(stage_fn, stage_params, x, y, n_micro, mesh,
                  axis: str = "pipe") -> torch.Tensor:
    out = pipeline_forward(stage_fn, stage_params, x, n_micro, mesh, axis)
    return torch.mean((out - y) ** 2)
