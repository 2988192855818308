"""Continuous-batching serving of packed models with a quantized KV cache."""
from .engine import (Engine, Request, RequestHandle, SamplingConfig,
                     generate)
from .kvcache import (KV_CACHE_MODES, kv_bytes_per_token, quantized_cache,
                      resolve_kv_bits)
from .packed import pack_for_serving, pack_tree, packed_nbytes

__all__ = ["Engine", "KV_CACHE_MODES", "Request", "RequestHandle",
           "SamplingConfig", "generate", "kv_bytes_per_token",
           "pack_for_serving", "pack_tree", "packed_nbytes",
           "quantized_cache", "resolve_kv_bits"]
