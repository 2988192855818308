"""Models ported: the decoder-only LM (dense, MoE and the VLM backbone),
Griffin (the hybrid family), RWKV-6 (the ssm family), Whisper (the audio
encoder-decoder) and the paper's three benchmark models."""
from .config import ModelConfig
from .griffin import GriffinLM
from .lm import TransformerLM
from .rwkv import RWKVCaches, RWKVLM
from .tasks import JetTagger, MuonTracker, SVHNNet
from .whisper import WhisperCaches, WhisperModel


def model_for(cfg: ModelConfig):
    """Dispatch an arch config to its model implementation."""
    if cfg.family == "hybrid":
        return GriffinLM
    if cfg.family == "ssm":
        return RWKVLM
    if cfg.family == "audio":
        return WhisperModel
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return TransformerLM


__all__ = ["GriffinLM", "JetTagger", "ModelConfig", "MuonTracker",
           "RWKVCaches", "RWKVLM", "SVHNNet", "TransformerLM",
           "WhisperCaches", "WhisperModel", "model_for"]
