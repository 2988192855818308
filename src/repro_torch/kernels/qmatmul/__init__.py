"""Packed-weight dequant matmul: int8 (or nibble-packed int4) mantissas x
per-channel 2^-f scale."""
from .ops import (channel_bits, grid_exponent, mantissa_max, pack_linear,
                  pack_nibbles, pack_weights, qmatmul, qmatmul_any,
                  qmatmul_split, unpack_nibbles)
from .ref import bf16_split3, pack_ref, qmatmul_ref

__all__ = ["bf16_split3", "channel_bits", "grid_exponent", "mantissa_max",
           "pack_linear", "pack_nibbles", "pack_ref", "pack_weights", "qmatmul",
           "qmatmul_any", "qmatmul_ref", "qmatmul_split", "unpack_nibbles"]
