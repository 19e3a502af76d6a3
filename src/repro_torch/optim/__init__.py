"""The optimizer (port of ``repro.optim``): AdamW and its schedules."""
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_update,
                                     global_norm, init_opt_state)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamWConfig", "OptState", "adamw_update", "global_norm",
           "init_opt_state", "constant", "warmup_cosine"]
