"""Model execution context (port of ``repro.models.context``): carries the
sharding plan, the mesh and the engine knobs into model functions.

``constrain`` is the identity. The reference annotates activations with
``with_sharding_constraint`` for GSPMD, which never changes a value; the
port runs explicit SPMD, one process a rank, where each rank holds the
activations it computes and the only collectives are the explicit ones
(``moe._moe_apply_ep``'s all-reduce), so there is nothing to annotate."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.planner import ShardingPlan

__all__ = ["Ctx"]


@dataclasses.dataclass
class Ctx:
    plan: Optional[ShardingPlan] = None
    use_flash: bool = False  # hand-written CUDA kernel paths (plain on CPU)
    quantize_dispatch: bool = False  # int8 round trip of the MoE buffer
    ep_shard_map: bool = False  # explicit expert parallelism over the mesh
    mesh: Optional[object] = None  # launch.mesh.Mesh: the EP path's groups
    deterministic: bool = True

    def constrain(self, x, *axes):
        return x
