"""Wire compression for the compressed data-parallel gradient reduce:
phase-1 quantize with its residual (per row, per position or per bucket
of leaves), nibble packing, phase-2 decode (per position or per bucket)."""
from .ops import (dequant_bucket, dequant_sum, grid_scale, pack_chunks,
                  quantize_bucket, quantize_chunks, quantize_leaf,
                  wire_dequant_bucket, wire_dequant_rows, wire_pack_rows,
                  wire_quantize_bucket, wire_quantize_rows,
                  wire_quantize_sflat)
from .ref import (bucket_layout, dequant_bucket_ref, dequant_sum_ref,
                  pack_chunks_ref, quantize_bucket_ref, quantize_chunks_ref,
                  quantize_leaf_ref, true_div)

__all__ = ["bucket_layout", "dequant_bucket", "dequant_bucket_ref",
           "dequant_sum", "dequant_sum_ref", "grid_scale", "pack_chunks",
           "pack_chunks_ref", "quantize_bucket", "quantize_bucket_ref",
           "quantize_chunks", "quantize_chunks_ref", "quantize_leaf",
           "quantize_leaf_ref", "true_div", "wire_dequant_bucket",
           "wire_dequant_rows", "wire_pack_rows", "wire_quantize_bucket",
           "wire_quantize_rows", "wire_quantize_sflat"]
