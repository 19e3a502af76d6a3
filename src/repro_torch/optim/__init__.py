"""The optimizer (port of ``repro.optim``): AdamW and its schedules."""
from repro_torch.optim.adamw import (AdamWConfig, OptState,
                                     abstract_opt_state, adamw_update,
                                     global_norm, init_opt_state,
                                     opt_state_specs)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamWConfig", "OptState", "abstract_opt_state", "adamw_update",
           "global_norm", "init_opt_state", "opt_state_specs", "constant",
           "warmup_cosine"]
