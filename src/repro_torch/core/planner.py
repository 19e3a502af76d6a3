"""The sharding planner (port of ``repro.core.planner``): "declarative in
the large" for the model side.

Users declare an architecture (configs) and a mesh; the planner makes every
distribution decision, the way PC's optimizer picks join orders and
algorithms (paper §1, §7). Decisions are recorded as human-readable
strings so the dry-run log shows *why* a plan was chosen. Key decisions:

* **MoE strategy** — expert-parallel ("hash-partition join") when the
  expert count divides the model axis, otherwise tensor-parallel within
  each expert ("broadcast join");
* **KV strategy for decode** — shard KV heads over the model axis when they
  divide it; otherwise shard the sequence;
* **FSDP** — shard params + optimizer state over the data axis for archs
  whose replicated state would not fit a device's memory;
* **Remat policy** — the materialization-point choice.

Models annotate every parameter with logical axes (e.g. ``("embed",
"heads")``); :meth:`ShardingPlan.spec` maps them to mesh axes as a
:class:`P`, the port's counterpart of ``jax.sharding.PartitionSpec``.

``hbm_bytes`` is the memory of one device that the FSDP decision string
compares against. Its default is the reference's (16 GiB, a TPU v5e chip),
so that plans equal the reference's; a caller planning for a card passes
``torch.cuda.get_device_properties(dev).total_memory``. Only the decision
string reads it: FSDP itself is the config's ``fsdp`` flag, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs import ArchConfig, ShapeConfig

__all__ = ["P", "ShardingPlan", "make_plan", "LOGICAL_TP_PRIORITY",
           "FSDP_CANDIDATES", "HBM_BYTES"]

# Logical axis names that prefer the model (TP) axis, in priority order.
LOGICAL_TP_PRIORITY = ("experts", "vocab", "heads", "kv_heads", "ff",
                       "inner", "q_dim")
# Logical axes eligible for FSDP sharding over the data axis.
FSDP_CANDIDATES = ("embed", "ff", "inner", "vocab")
HBM_BYTES = 16 * 2**30  # the reference's default: one TPU v5e chip


class P(tuple):
    """A partition spec: one entry a dimension, ``None`` (whole), a mesh
    axis name, or a tuple of names (one dimension split over several
    axes, the first the major one). ``P()`` is whole on every rank. A
    leaf of ``repro_torch.tree``'s walks, not a tuple of leaves."""

    tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):  # pickle rebuilds P(*entries)
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass
class ShardingPlan:
    arch: ArchConfig
    mesh_axes: Dict[str, int]  # e.g. {"pod": 2, "data": 16, "model": 16}
    shape_kind: str  # train | prefill | decode
    moe_strategy: str  # ep | tp | none
    kv_strategy: str  # heads | sequence
    fsdp: bool
    remat: str
    decisions: List[str]
    shard_batch: bool = True  # False when global_batch < dp size (long_500k)
    tp_disabled: bool = False  # small models: replicate weights, pure DP
    batch_extra_axes: Tuple[str, ...] = ()  # extra axes batch shards over

    # ------------------------------------------------------------ axes
    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.mesh_axes)

    @property
    def tp_axis(self) -> Optional[str]:
        if self.tp_disabled:
            return None
        return "model" if "model" in self.mesh_axes else None

    @property
    def tp_size(self) -> int:
        return self.mesh_axes.get("model", 1)

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.mesh_axes[a]
        return n

    # --------------------------------------------------------- param specs
    def spec(self, *logical: Optional[str]) -> P:
        """Map logical parameter axes to mesh axes (None = replicated dim)."""
        tp_logical = self._tp_logical()
        out: List = []
        used_model = used_data = False
        for name in logical:
            if (name is not None and name in tp_logical and not used_model
                    and self.tp_axis is not None
                    and self._divides(name, self.tp_size)):
                out.append(self.tp_axis)
                used_model = True
            else:
                out.append(None)
        if self.fsdp and "data" in self.mesh_axes:
            dsize = self.mesh_axes["data"]
            for i, name in enumerate(logical):
                if (out[i] is None and name in FSDP_CANDIDATES
                        and not used_data
                        and self._divides(name, dsize)):
                    out[i] = "data"
                    used_data = True
        return P(*out)

    def _tp_logical(self) -> Tuple[str, ...]:
        tp = ["vocab", "heads", "ff", "inner", "q_dim"]
        if self.moe_strategy == "ep":
            tp.insert(0, "experts")
        if self.kv_strategy == "heads":
            tp.append("kv_heads")
        return tuple(tp)

    def _divides(self, logical: str, n: int) -> bool:
        a = self.arch
        size = {
            "vocab": a.padded_vocab,
            "heads": a.n_heads,
            "kv_heads": a.n_kv_heads,
            "ff": a.d_ff or 1,
            "experts": a.n_experts or 1,
            "embed": a.d_model,
            "inner": a.ssm_expand * a.d_model,
            "q_dim": a.n_heads * a.resolved_head_dim,
        }.get(logical, 0)
        return size % n == 0 and size >= n

    # ----------------------------------------------------- activation specs
    def act_spec(self, *logical: Optional[str]) -> P:
        """Activations: batch over DP axes, seq/heads optionally over model."""
        out: List = []
        for name in logical:
            if name == "batch":
                if not self.shard_batch:
                    out.append(None)
                    continue
                dp = (*self.dp_axes, *self.batch_extra_axes)
                out.append(dp if len(dp) > 1 else (dp[0] if dp else None))
            elif name == "experts" and self.moe_strategy == "ep" and self.tp_axis:
                out.append(self.tp_axis)
            elif name in ("heads", "inner") and self.tp_axis:
                out.append(self.tp_axis)
            elif name == "kv_seq" and self.kv_strategy == "sequence" and self.tp_axis:
                out.append(self.tp_axis)
            elif name == "vocab" and self.tp_axis:
                out.append(self.tp_axis)
            else:
                out.append(None)
        return P(*out)


def make_plan(arch: ArchConfig, mesh_axes: Dict[str, int],
              shape: ShapeConfig, *, allow_dp_only: bool = False,
              hbm_bytes: int = HBM_BYTES) -> ShardingPlan:
    tp = mesh_axes.get("model", 1)
    decisions: List[str] = []

    # --- tiny models gain nothing from TP (d_model/16 slivers starve the
    # matrix units and every layer pays 4 all-reduces) -> replicate
    # weights, run pure DP over the whole mesh when they fit.
    tp_disabled = False
    batch_extra: Tuple[str, ...] = ()
    if allow_dp_only:
        moment_b = 2 if arch.moment_dtype == "bfloat16" else 4
        replicated = arch.param_count() * (2 + 4 + 2 * moment_b)
        if replicated < 4 * 2**30 and arch.d_model // max(tp, 1) < 256:
            tp_disabled = True
            dp_sz = 1
            for a in ("pod", "data"):
                dp_sz *= mesh_axes.get(a, 1)
            if shape.global_batch % (dp_sz * tp) == 0 and tp > 1:
                batch_extra = ("model",)
            decisions.append(
                f"TP disabled: {replicated/2**30:.2f} GiB replicated state "
                f"fits; d_model/{tp}={arch.d_model//max(tp,1)} would starve "
                "the MXU -> pure DP"
                + (" with batch over the model axis too" if batch_extra
                   else ""))

    # --- MoE: hash-partition join (EP/all-to-all) vs broadcast join (TP)
    if not arch.is_moe:
        moe = "none"
    elif arch.n_experts % tp == 0 and tp > 1:
        moe = "ep"
        decisions.append(
            f"MoE: {arch.n_experts} experts % model={tp} == 0 -> expert "
            "parallelism (hash-partition join: all-to-all dispatch by "
            "expert-id key)")
    else:
        moe = "tp"
        decisions.append(
            f"MoE: {arch.n_experts} experts do not divide model={tp} -> "
            "TP within experts (broadcast join: activations all-gathered, "
            "expert FFN column/row sharded)")

    # --- KV strategy for decode
    if shape.kind == "decode":
        if arch.n_kv_heads % tp == 0 and arch.n_kv_heads >= tp:
            kv = "heads"
            decisions.append(
                f"KV: {arch.n_kv_heads} kv-heads divide model={tp} -> "
                "head-sharded KV cache")
        else:
            kv = "sequence"
            decisions.append(
                f"KV: {arch.n_kv_heads} kv-heads < model={tp} -> "
                "sequence-sharded (paged) KV with flash-decode LSE combine")
    else:
        kv = "heads" if arch.n_kv_heads % max(tp, 1) == 0 else "sequence"

    # --- FSDP: needed iff replicated params + moments would blow the memory
    fsdp = arch.fsdp
    n_params = arch.param_count()
    moment_bytes = 2 if arch.moment_dtype == "bfloat16" else 4
    state_bytes = n_params * (2 + 2 * moment_bytes) / max(tp, 1)
    if shape.kind != "train":
        state_bytes = n_params * 2 / max(tp, 1)  # no optimizer state
    if fsdp:
        decisions.append(
            f"FSDP on: {state_bytes / 2**30:.1f} GiB/chip at TP-only would "
            f"{'exceed' if state_bytes > hbm_bytes else 'approach'} "
            f"{hbm_bytes / 2**30:.0f} GiB HBM -> shard over data axis")
    else:
        decisions.append(
            f"FSDP off: {state_bytes / 2**30:.2f} GiB/chip replicated state fits")

    remat = arch.remat if shape.kind == "train" else "none"
    decisions.append(f"remat={remat} (materialization-point policy)")

    dp = 1
    for a in ("pod", "data"):
        dp *= mesh_axes.get(a, 1)
    shard_batch = shape.global_batch % dp == 0 and shape.global_batch >= dp
    if not shard_batch:
        decisions.append(
            f"batch={shape.global_batch} < dp={dp}: batch replicated, "
            "sequence/state dims carry the parallelism instead")

    if tp_disabled:
        moe, kv, fsdp = "none" if not arch.is_moe else "tp", "heads", False
    return ShardingPlan(arch=arch, mesh_axes=dict(mesh_axes),
                        shape_kind=shape.kind, moe_strategy=moe,
                        kv_strategy=kv, fsdp=fsdp, remat=remat,
                        decisions=decisions, shard_batch=shard_batch,
                        tp_disabled=tp_disabled, batch_extra_axes=batch_extra)
