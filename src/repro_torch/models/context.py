"""Model execution context (port of ``repro.models.context``): carries the
sharding plan, the mesh and the engine knobs into model functions.

``constrain`` is the identity. The reference annotates activations with
``with_sharding_constraint`` for GSPMD, which never changes a value; the
port runs explicit SPMD, one process a rank, where each rank holds the
activations it computes and the only collectives are the explicit ones,
so there is nothing to annotate. A rank holds its slice of every leaf
under ``Model.param_specs(plan)``: the dense layers' heads, ff and vocab
split over the plan's model axis (``tp`` ranks, this one at
``tp_index``), the experts too under expert parallelism. The layers read
what they hold from their leaves' shapes, and sum a split product's
partials with one all-reduce over ``tp_group`` (``models.layers``,
``models.attention``, ``models.moe``). Over a data axis the batch is
split into ``dp`` shards (``dp_groups``, one group a data axis of more
than one rank); ``global_aux`` (the train step sets it) takes the MoE
load-balance loss over the global batch, where serving keeps each
shard's own.

Under FSDP (a plan with ``fsdp`` on a data axis of ``fsdp`` > 1 ranks) a
rank also holds only its block of each leaf's dim that ``param_specs``
places on ``data`` (``data_dims``); the model all-gathers a leaf over
``data_group`` where a layer takes it, inside the layer's remat region,
and the gather's backward reduce-scatters the leaf's gradient
(``collectives.gather_data``), so a layer sees the leaf the model axis
alone would split.

Under the plan's "sequence" kv strategy on a model axis of tp > 1
(``kv_seq``) a rank's decode cache is its span of the positions
(``seq_span``), over the axes that dim 2 of the cache's spec names; the
ranks of those axes (``seq_group``) merge their attention partials."""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

from repro_torch.core.planner import ShardingPlan

__all__ = ["Ctx"]


@dataclasses.dataclass
class Ctx:
    plan: Optional[ShardingPlan] = None
    use_flash: bool = False  # hand-written CUDA kernel paths (plain on CPU)
    quantize_dispatch: bool = False  # int8 round trip of the MoE buffer
    ep_shard_map: bool = False  # explicit expert parallelism over the mesh
    mesh: Optional[object] = None  # launch.mesh.Mesh: the split paths' groups
    deterministic: bool = True
    global_aux: bool = False  # MoE aux over the data shards (training)

    def constrain(self, x, *axes):
        return x

    @property
    def tp(self) -> int:
        """The ranks of the plan's model axis that split this rank's
        leaves: 1 without a mesh, or when the plan has no model axis."""
        if self.mesh is None or self.plan is None or \
                self.plan.tp_axis is None:
            return 1
        return self.plan.tp_size

    @property
    def tp_index(self) -> int:
        """This rank's coordinate along the model axis (0 when tp is 1)."""
        return self.mesh.index(self.plan.tp_axis) if self.tp > 1 else 0

    @property
    def tp_group(self):
        """The process group of this rank's line along the model axis."""
        if self.tp == 1:
            raise ValueError("a leaf split over the model axis needs a "
                             "Ctx with the plan and the mesh")
        return self.mesh.group(self.plan.tp_axis)

    @property
    def dp(self) -> int:
        """The data shards the batch is split over: 1 without a mesh or
        where the plan keeps the batch whole."""
        if self.mesh is None or self.plan is None or \
                not self.plan.shard_batch:
            return 1
        return self.plan.dp_size

    @property
    def dp_index(self) -> int:
        """This rank's data shard (the data axes row-major, as a batch
        spec over several of them splits)."""
        i = 0
        if self.dp > 1:
            for a in self.plan.dp_axes:
                i = i * self.plan.mesh_axes[a] + self.mesh.index(a)
        return i

    @property
    def dp_groups(self) -> list:
        """The process groups of this rank's lines along each data axis
        of more than one rank: a sum over all of them in turn is the sum
        over the data shards."""
        if self.dp == 1:
            return []
        return [self.mesh.group(a) for a in self.plan.dp_axes
                if self.plan.mesh_axes[a] > 1]

    @property
    def fsdp(self) -> int:
        """The ranks of the data axis that split this rank's leaves
        (FSDP): 1 without a mesh, without ``plan.fsdp`` or without a data
        axis of more than one rank."""
        if self.mesh is None or self.plan is None or not self.plan.fsdp:
            return 1
        return self.plan.mesh_axes.get("data", 1)

    @property
    def data_group(self):
        """The process group of this rank's line along the data axis."""
        return self.mesh.group("data")

    @functools.cached_property
    def data_dims(self) -> Dict:
        """A tree of the parameters' structure (``plan.arch``'s): the dim
        of each leaf that ``param_specs(plan)`` places on the data axis,
        None where the leaf is whole over it."""
        from repro_torch import tree as tr
        from repro_torch.models import params as pp
        from repro_torch.models.transformer import model_defs
        return tr.tree_map(lambda spec: next(
            (i for i, e in enumerate(spec) if e == "data"
             or (isinstance(e, tuple) and "data" in e)), None),
            pp.specs(model_defs(self.plan.arch), self.plan))

    @property
    def kv_seq(self) -> bool:
        """Whether decode runs over a sequence-sharded cache: the plan's
        "sequence" kv strategy on a model axis of tp > 1."""
        return self.tp > 1 and self.plan.kv_strategy == "sequence"

    def _seq_axes(self) -> Tuple[str, ...]:
        """The mesh axes of dim 2 of the sequence-sharded cache's spec
        (``model_zoo._kv_spec``), the first the major one."""
        from repro_torch.models.model_zoo import _kv_spec
        axes = _kv_spec(self.plan, heads=False)[2]
        return axes if isinstance(axes, tuple) else (axes,)

    @property
    def seq_span(self) -> Tuple[int, int]:
        """(index, count): this rank's span of a sequence-sharded cache's
        positions in span order, and the spans, from the axes that dim 2 of
        the cache's spec names: the model axis, or with the batch
        replicated the data axes then the model axis."""
        index, count = 0, 1
        for axis in self._seq_axes():
            n = self.plan.mesh_axes[axis]
            index, count = index * n + self.mesh.index(axis), count * n
        return index, count

    @property
    def seq_group(self):
        """The process group of this rank's spans, its group ranks in span
        order: the model axis's line, or the whole world where the spans
        lie over every axis of the mesh in its order (None: the default
        group)."""
        axes = self._seq_axes()
        if len(axes) == 1:
            return self.mesh.group(axes[0])
        if tuple(self.mesh.shape) != axes:
            raise NotImplementedError(
                f"spans over {axes} on a mesh of {tuple(self.mesh.shape)}: "
                f"the spans' group is the mesh's every axis in its order")
        return None
