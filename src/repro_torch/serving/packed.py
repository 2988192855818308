"""HGQ quantized-packed serving weights (counterpart of
``repro/serving/packed.py``): every matmul kernel ``{'w', 'f'}`` becomes
``{'w_int8' | 'w_nib', 'scale', 'f'}`` at its ``PrecisionPlan`` pack
width, the representation the ``qmatmul`` kernel consumes."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..dist.perf import pack_params_for_serving


def pack_tree(params: Any, plan=None) -> Any:
    """Rewrite every packable matmul weight to its serving form (uniform
    int8 when ``plan`` is None); structure-preserving elsewhere."""
    return pack_params_for_serving(params, plan)


def pack_for_serving(params: Any, qstate: Any,
                     plan=None) -> Tuple[Any, Any]:
    """Trained ``(params, qstate)`` -> the serving tree; qstate passes
    through (inference quantizers read only the ``f`` leaves)."""
    return pack_tree(params, plan), qstate


def packed_nbytes(params: Any) -> int:
    """Total bytes of the tensor leaves as stored."""
    def walk(obj):
        if isinstance(obj, dict):
            return sum(walk(v) for v in obj.values())
        if isinstance(obj, (list, tuple)):
            return sum(walk(v) for v in obj)
        if isinstance(obj, torch.Tensor):
            return obj.numel() * obj.element_size()
        return 0
    return walk(params)
