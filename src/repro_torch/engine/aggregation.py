"""Two-stage aggregation and distributed joins over a mesh axis (port of
``repro.engine.aggregation``, paper App. D), as explicit collectives.

Each function runs on every rank of the axis with that rank's shard, and
takes the axis's process group (``launch.mesh.Mesh.group(axis)``) where
the reference's shard_map body takes ``axis_name``:

* :func:`two_stage_aggregate` — segment pre-aggregation per shard, then a
  reduce-scatter "shuffle" so each shard finalizes its own partitions;
* :func:`grad_reduce_two_stage` — the same plan over a gradient tree:
  reduce-scatter over the axis where a leaf's first dim divides it, else
  all-reduce;
* :func:`broadcast_join` / :func:`hash_partition_join` — the two join
  algorithms over (key, value) rows: the build side all-gathered, or rows
  repartitioned by key hash through an all-to-all.

The local steps are plain tensor ops, as the reference's are jnp ops
outside any kernel; the collectives are ``distributed.collectives``'.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as tr
from repro_torch.distributed import collectives as coll

__all__ = ["segment_preaggregate", "two_stage_aggregate",
           "grad_reduce_two_stage", "broadcast_join", "hash_partition_join"]


def segment_preaggregate(keys: torch.Tensor, values: torch.Tensor,
                         num_buckets: int) -> torch.Tensor:
    """Stage 1: local segment-sum into a dense bucket map (combiner page).

    keys: (T,) integers in [0, num_buckets); values: (T, ...)."""
    out = torch.zeros((num_buckets, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, keys.long(), values)


def two_stage_aggregate(keys: torch.Tensor, values: torch.Tensor,
                        num_buckets: int, group) -> torch.Tensor:
    """Pre-aggregate locally, then reduce-scatter so the shard of group
    rank i owns buckets [i * nb/n, (i+1) * nb/n), finalized."""
    return coll.reduce_scatter(
        segment_preaggregate(keys, values, num_buckets), group)


def grad_reduce_two_stage(grads: Any, group) -> Any:
    """Reduce-scatter each gradient leaf over its first dim where the axis
    divides it (the rank keeps its rows, summed); all-reduce the small or
    indivisible leaves. The caller's tensors are left as they are."""
    import torch.distributed as dist
    n = dist.get_world_size(group)

    def red(g: torch.Tensor) -> torch.Tensor:
        if g.ndim >= 1 and g.shape[0] % n == 0 and g.shape[0] >= n:
            return coll.reduce_scatter(g, group)
        return coll.all_reduce(g.clone(), group)

    return tr.tree_map(red, grads)


def broadcast_join(probe_keys: torch.Tensor, build_keys: torch.Tensor,
                   build_values: torch.Tensor, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Broadcast join: the (small) build side is all-gathered to every
    shard (with ``group``), the probe side stays put. Returns (matched
    mask, joined values); the build side must have unique keys."""
    if group is not None:
        build_keys = coll.all_gather(build_keys, group)
        build_values = coll.all_gather(build_values, group)
    order = torch.argsort(build_keys, stable=True)
    sk = build_keys[order]
    idx = torch.searchsorted(sk, probe_keys).clamp(0, sk.shape[0] - 1)
    matched = sk[idx] == probe_keys
    vals = build_values[order][idx]
    return matched, vals


def hash_partition_join(keys: torch.Tensor, values: torch.Tensor,
                        num_partitions: int, group
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repartition (key, value) rows by key hash across the group through
    an all-to-all — the shuffle stage of PC's hash join. Rows are binned
    into per-destination buckets of ``T // n * 2`` (combiner pages);
    overflow rows are dropped, as in the MoE dispatch.

    keys: (T,), values: (T, d). Returns the rank's received (keys (n, cap),
    values (n, cap, d)), row j from group rank j, key -1 an empty slot."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    T = keys.shape[0]
    cap = T // n * 2  # per-destination capacity
    dev = keys.device
    dest = torch.div((keys % num_partitions) * n, num_partitions,
                     rounding_mode="floor")
    order = torch.argsort(dest, stable=True)
    sd, sk, sv = dest[order], keys[order], values[order]
    start = torch.searchsorted(sd, torch.arange(n, device=dev))
    rank = torch.arange(T, device=dev) - start[sd]
    slot = torch.where(rank < cap, sd * cap + rank, n * cap)
    out_k = torch.full((n * cap + 1,), -1, dtype=keys.dtype, device=dev)
    out_v = values.new_zeros((n * cap + 1, values.shape[-1]))
    out_k[slot] = sk  # overflow rows all land on the trash slot n * cap
    out_v[slot] = sv
    return (coll.all_to_all(out_k[:-1].reshape(n, cap), group),
            coll.all_to_all(out_v[:-1].reshape(n, cap, -1), group))
