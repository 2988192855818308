"""Quantized layer library (the dense LM and the jet tagger's subset)."""
from .attention import (AttnConfig, GQAAttention, KVCache, QKVCache,
                        decode_positions, rope)
from .basic import HDense, HEmbedding, LayerNorm, RMSNorm, activation
from .common import FP_BASELINE, HGQConfig
from .mlp import GLUMLP

__all__ = ["AttnConfig", "FP_BASELINE", "GLUMLP", "GQAAttention", "HDense",
           "HEmbedding", "HGQConfig", "KVCache", "LayerNorm", "QKVCache",
           "RMSNorm", "activation", "decode_positions", "rope"]
