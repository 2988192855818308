"""Models ported so far: the dense decoder-only LM."""
from .config import ModelConfig
from .lm import TransformerLM


def model_for(cfg: ModelConfig):
    """Dispatch an arch config to its model implementation."""
    if cfg.family not in ("dense",):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return TransformerLM


__all__ = ["ModelConfig", "TransformerLM", "model_for"]
