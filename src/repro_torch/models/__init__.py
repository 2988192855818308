"""Models ported so far: the dense decoder-only LM and the paper's three
benchmark models."""
from .config import ModelConfig
from .lm import TransformerLM
from .tasks import JetTagger, MuonTracker, SVHNNet


def model_for(cfg: ModelConfig):
    """Dispatch an arch config to its model implementation."""
    if cfg.family not in ("dense",):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return TransformerLM


__all__ = ["JetTagger", "ModelConfig", "MuonTracker", "SVHNNet",
           "TransformerLM", "model_for"]
