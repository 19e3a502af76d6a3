"""Model execution context (port of ``repro.models.context``).

Only the knobs the ported path reads. There is no sharding plan yet, so
``constrain`` is the identity."""
from __future__ import annotations

import dataclasses

__all__ = ["Ctx"]


@dataclasses.dataclass
class Ctx:
    use_flash: bool = False  # hand-written CUDA kernel paths (plain on CPU)
    quantize_dispatch: bool = False  # int8 round trip of the MoE buffer
    ep_shard_map: bool = False  # explicit expert parallelism: not ported
    deterministic: bool = True

    def constrain(self, x, *axes):
        return x
