"""Models ported so far: the decoder-only LM (dense, MoE and the VLM
backbone), Griffin (the hybrid family), RWKV-6 (the ssm family) and the
paper's three benchmark models."""
from .config import ModelConfig
from .griffin import GriffinLM
from .lm import TransformerLM
from .rwkv import RWKVCaches, RWKVLM
from .tasks import JetTagger, MuonTracker, SVHNNet


def model_for(cfg: ModelConfig):
    """Dispatch an arch config to its model implementation."""
    if cfg.family == "hybrid":
        return GriffinLM
    if cfg.family == "ssm":
        return RWKVLM
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return TransformerLM


__all__ = ["GriffinLM", "JetTagger", "ModelConfig", "MuonTracker",
           "RWKVCaches", "RWKVLM", "SVHNNet", "TransformerLM", "model_for"]
