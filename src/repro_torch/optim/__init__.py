"""Optimizers over trees of tensors."""
from .optimizers import (AdamWState, LionState, adamw_init, adamw_update,
                         clip_by_global_norm, lion_init, lion_update,
                         sgd_update)

__all__ = ["AdamWState", "LionState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "lion_init", "lion_update", "sgd_update"]
