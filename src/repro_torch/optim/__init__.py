from .adamw import adamw_init, adamw_update, global_norm
from .schedules import constant_lr, cosine_warmup, step_decay

__all__ = ["adamw_init", "adamw_update", "global_norm", "constant_lr",
           "cosine_warmup", "step_decay"]
