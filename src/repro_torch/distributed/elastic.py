"""Elastic scaling (port of ``repro.distributed.elastic``): checkpoints
are mesh-independent, so a job restarted on a different worker count
re-plans (planner), re-shards (``reshard_state``, which
``Checkpointer.restore(..., specs=, mesh=)`` calls) and re-balances its
data shards (``rebalance_shards``, the reference's arithmetic).

``reshard_state`` is the counterpart of ``jax.device_put`` with a
``NamedSharding``: one process a rank, each rank keeps the slice of every
leaf that its mesh coordinates own, on its device. A spec entry naming one
axis splits its dim into that axis's size of equal blocks; a tuple of
axes splits it into their product, the first axis the major one (JAX's
order); ``None``, or a dim past the spec's end, stays whole."""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch import tree as tr

__all__ = ["rebalance_shards", "reshard_state", "local_slice",
           "local_index", "split_axes", "split_over"]


def rebalance_shards(n_pages: int, old_workers: int, new_workers: int,
                     old_cursors: Dict[int, int]) -> Dict[int, List[int]]:
    """Round-robin page assignment for the new worker count; cursors are
    aggregated so no record is dropped or double-trained (coarse page
    granularity, same policy as PC's storage re-partitioning)."""
    assignment: Dict[int, List[int]] = {w: [] for w in range(new_workers)}
    for p in range(n_pages):
        assignment[p % new_workers].append(p)
    return assignment


def local_index(shape, spec, mesh) -> tuple:
    """The slices of a whole leaf of ``shape`` that ``mesh``'s rank owns
    under ``spec``: a block of ``models.params.local_shape``."""
    from repro_torch.models.params import local_shape
    size = local_shape(tuple(shape), spec, mesh.shape)
    out = [slice(None)] * len(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        block = 0
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            block = block * mesh.shape[a] + mesh.index(a)  # major first
        out[dim] = slice(block * size[dim], (block + 1) * size[dim])
    return tuple(out)


def split_axes(spec) -> List[tuple]:
    """[(dim, the mesh axes it is split over)] of a spec's split dims."""
    return [(dim, entry if isinstance(entry, tuple) else (entry,))
            for dim, entry in enumerate(spec) if entry is not None]


def split_over(spec, mesh) -> tuple:
    """The axes of ``mesh`` of more than one rank that split a leaf
    under ``spec``, in the spec's order: those over which the ranks hold
    different blocks of it."""
    return tuple(a for _, axes in split_axes(spec) for a in axes
                 if mesh.shape[a] > 1)


def local_slice(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The view of the whole ``x`` that ``mesh``'s rank owns under
    ``spec`` (:func:`local_index`)."""
    return x[local_index(x.shape, spec, mesh)]


def reshard_state(state: Any, specs: Any, mesh) -> Any:
    """Place a whole (host-resident) state tree onto ``mesh``: each leaf
    (a tensor or an array) becomes this rank's slice under its spec, a
    tensor of its own on ``mesh.device``."""
    def place(leaf, spec):
        part = local_slice(torch.as_tensor(leaf), spec, mesh)
        return part.to(mesh.device, memory_format=torch.contiguous_format,
                       copy=True)
    return tr.tree_map(place, state, specs)
