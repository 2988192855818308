"""Quantized-KV-cache kernels for the serving decode path."""
from .ops import (attention_cluster, kv_attention_decode, kv_attention_rows,
                  kv_dequant, kv_dequant_rows, kv_pack, kv_quantize,
                  kv_quantize_rows, kv_quantize_store, kv_unpack)

__all__ = ["attention_cluster", "kv_attention_decode", "kv_attention_rows",
           "kv_dequant", "kv_dequant_rows", "kv_pack", "kv_quantize",
           "kv_quantize_rows", "kv_quantize_store", "kv_unpack"]
