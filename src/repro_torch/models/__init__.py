"""The port's model stack (dense and MoE decoder-only families so far)."""
from repro_torch.models.context import Ctx
from repro_torch.models.model_zoo import Model, build_model, resolve_device
from repro_torch.models.params import ParamDef, count, initialize

__all__ = ["Ctx", "Model", "build_model", "resolve_device", "ParamDef",
           "count", "initialize"]
