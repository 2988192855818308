"""Wire compression for the compressed data-parallel gradient reduce:
phase-1 quantize with its residual (per row or per position), nibble
packing, phase-2 decode."""
from .ops import (dequant_sum, grid_scale, pack_chunks, quantize_chunks,
                  quantize_leaf, wire_dequant_rows, wire_pack_rows,
                  wire_quantize_rows, wire_quantize_sflat)
from .ref import (dequant_sum_ref, pack_chunks_ref, quantize_chunks_ref,
                  quantize_leaf_ref, true_div)

__all__ = ["dequant_sum", "dequant_sum_ref", "grid_scale", "pack_chunks",
           "pack_chunks_ref", "quantize_chunks", "quantize_chunks_ref",
           "quantize_leaf", "quantize_leaf_ref", "true_div",
           "wire_dequant_rows", "wire_pack_rows", "wire_quantize_rows",
           "wire_quantize_sflat"]
