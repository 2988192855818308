"""Quantized layer library (the dense LM's and the paper models' subset)."""
from .attention import (AttnConfig, GQAAttention, KVCache, QKVCache,
                        decode_positions, rope)
from .basic import HConv2D, HDense, HEmbedding, LayerNorm, RMSNorm, activation
from .common import FP_BASELINE, HGQConfig
from .mlp import GLUMLP

__all__ = ["AttnConfig", "FP_BASELINE", "GLUMLP", "GQAAttention", "HConv2D",
           "HDense", "HEmbedding", "HGQConfig", "KVCache", "LayerNorm",
           "QKVCache", "RMSNorm", "activation", "decode_positions", "rope"]
