"""Deployment utilities; slice 1 ports only the serving-weight packing."""
from .perf import (is_packed, pack_params_for_serving, packed_mantissas,
                   unpack_weight)

__all__ = ["is_packed", "pack_params_for_serving", "packed_mantissas",
           "unpack_weight"]
