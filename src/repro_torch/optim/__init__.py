from repro_torch.optim.adamw import (
    AdamWConfig, adamw_init, adamw_update, global_norm)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm"]
