"""Input specs for every (arch x shape) cell (port of
``repro.engine.specs``): meta-tensor stand-ins (shape and dtype, no
storage) plus their partition specs, what the dry-run counts against."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ShapeConfig
from repro_torch.core.planner import P, ShardingPlan
from repro_torch.models.model_zoo import Model, _batch_axis
from repro_torch.models.params import torch_dtype

__all__ = ["input_specs", "input_shardings", "abstract_decode_state"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device="meta")


def input_specs(model: Model, shape: ShapeConfig) -> Dict[str, Any]:
    """Batch stand-ins for train/prefill; token for decode."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    dt = cfg.param_dtype
    if shape.kind == "decode":
        return {"token": _meta((B, 1), torch.int32)}
    specs = {"tokens": _meta((B, S), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = _meta((B, S), torch.int32)
    if cfg.family == "audio":
        # stub conv frontend: precomputed frame embeddings
        specs["frames"] = _meta((B, cfg.encoder_len, cfg.d_model), dt)
    if cfg.family == "vlm":
        # stub ViT: precomputed patch embeddings
        specs["patches"] = _meta((B, cfg.n_patches, cfg.d_model), dt)
    return specs


def input_shardings(model: Model, shape: ShapeConfig, plan: ShardingPlan
                    ) -> Dict[str, P]:
    b = _batch_axis(plan)
    cfg = model.cfg
    if shape.kind == "decode":
        return {"token": P(b, None)}
    out = {"tokens": P(b, None)}
    if shape.kind == "train":
        out["labels"] = P(b, None)
    if cfg.family == "audio":
        out["frames"] = P(b, None, None)
    if cfg.family == "vlm":
        out["patches"] = P(b, None, None)
    return out


def abstract_decode_state(model: Model, shape: ShapeConfig,
                          kv_dtype: Optional[str] = None):
    """The decode state on the meta device (no storage)."""
    return model.init_decode_state(shape.global_batch, shape.seq_len,
                                   kv_dtype=kv_dtype, device="meta")
