"""Packed-weight dequant matmul: int8 mantissas x per-channel 2^-f scale."""
from .ops import (channel_bits, grid_exponent, mantissa_max, pack_linear,
                  pack_nibbles, pack_weights, qmatmul, qmatmul_any,
                  unpack_nibbles)
from .ref import pack_ref, qmatmul_ref

__all__ = ["channel_bits", "grid_exponent", "mantissa_max", "pack_linear",
           "pack_nibbles", "pack_ref", "pack_weights", "qmatmul",
           "qmatmul_any", "qmatmul_ref", "unpack_nibbles"]
