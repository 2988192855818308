"""Quantization-aware training: losses, the step, the loop, checkpoints."""
from . import checkpoint
from .losses import accuracy, lm_loss, mse, rms_resolution, softmax_xent
from .loop import TrainConfig, Trainer, make_train_step

__all__ = ["TrainConfig", "Trainer", "accuracy", "checkpoint", "lm_loss",
           "make_train_step", "mse", "rms_resolution", "softmax_xent"]
