"""Optimizers over trees of tensors."""
from .optimizers import (AdamWState, LionState, adamw_init, adamw_update,
                         clip_by_global_norm, clip_by_global_norm_,
                         lion_init, lion_update,
                         sgd_update)

__all__ = ["AdamWState", "LionState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "clip_by_global_norm_", "lion_init",
           "lion_update", "sgd_update"]
