"""Continuous-batching serving of packed models with a quantized KV cache,
and streaming ASR (audio-chunk requests beside LM traffic)."""
from .engine import (Engine, Request, RequestHandle, SamplingConfig,
                     generate)
from .kvcache import (KV_CACHE_MODES, kv_bytes_per_token,
                      kv_cross_bytes_per_request, quantized_cache,
                      resolve_kv_bits)
from .packed import pack_for_serving, pack_tree, packed_nbytes
from .streaming import (AudioRequest, StreamingEngine, generate_asr,
                        split_audio)

__all__ = ["AudioRequest", "Engine", "KV_CACHE_MODES", "Request",
           "RequestHandle", "SamplingConfig", "StreamingEngine", "generate",
           "generate_asr", "kv_bytes_per_token", "kv_cross_bytes_per_request",
           "pack_for_serving", "pack_tree", "packed_nbytes",
           "quantized_cache", "resolve_kv_bits", "split_audio"]
