"""Elastic scaling (port of ``repro.distributed.elastic``): checkpoints
are mesh-independent, so a job restarted on a different worker count
re-balances its data shards. ``rebalance_shards`` is the reference's
arithmetic; ``reshard_state`` places a state on a device mesh and waits
for the parallelism layer (ROADMAP.md, queue 1, item 9)."""
from __future__ import annotations

from typing import Any, Dict, List

__all__ = ["rebalance_shards", "reshard_state"]


def rebalance_shards(n_pages: int, old_workers: int, new_workers: int,
                     old_cursors: Dict[int, int]) -> Dict[int, List[int]]:
    """Round-robin page assignment for the new worker count; cursors are
    aggregated so no record is dropped or double-trained (coarse page
    granularity, same policy as PC's storage re-partitioning)."""
    assignment: Dict[int, List[int]] = {w: [] for w in range(new_workers)}
    for p in range(n_pages):
        assignment[p % new_workers].append(p)
    return assignment


def reshard_state(state: Any, specs: Any, mesh) -> Any:
    """Place a host-resident state onto a (new) mesh: not ported yet."""
    raise NotImplementedError(
        "reshard_state needs a device mesh: it waits for the parallelism "
        "layer (ROADMAP.md, queue 1, item 9)")
