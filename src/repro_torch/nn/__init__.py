"""Quantized layer library (the LM's -- dense and MoE --, the recurrent
families' mixers, Whisper's plain MLP and the paper models' subset)."""
from .attention import (AttnConfig, GQAAttention, KVCache, QKVCache,
                        decode_positions, rope)
from .basic import HConv2D, HDense, HEmbedding, LayerNorm, RMSNorm, activation
from .common import FP_BASELINE, HGQConfig
from .mlp import GLUMLP, MLP
from .moe import MoE, MoEConfig
from .recurrent import RWKVChannelMix, RWKVConfig, RWKVState, RWKVTimeMix

__all__ = ["AttnConfig", "FP_BASELINE", "GLUMLP", "GQAAttention", "HConv2D",
           "HDense", "HEmbedding", "HGQConfig", "KVCache", "LayerNorm", "MLP",
           "MoE", "MoEConfig", "QKVCache", "RMSNorm", "RWKVChannelMix",
           "RWKVConfig", "RWKVState", "RWKVTimeMix", "activation",
           "decode_positions", "rope"]
