"""Plain PyTorch versions of the HGQ quantizer kernels (counterpart of
``repro/kernels/hgq_quantize/ref.py``, plus the backward of
``repro/kernels/hgq_quantize/ops.py``)."""
from __future__ import annotations

from typing import List, Sequence

import torch

from ...core.quantizer import quantize_inference

LN2 = 0.6931471805599453


def hgq_quantize_ref(x: torch.Tensor, f: torch.Tensor,
                     epsilon: float = 0.5) -> torch.Tensor:
    """Eq. 4, ``floor(x * 2^fi + eps) / 2^fi`` with ``fi = floor(f + 0.5)``
    and f broadcast against x, in float32, cast back to x's dtype: the
    function ``core.quantizer.quantize_inference`` computes."""
    return quantize_inference(x, f, epsilon)


def hgq_quantize_grad_ref(g: torch.Tensor, x: torch.Tensor,
                          f: torch.Tensor) -> torch.Tensor:
    """The surrogate gradient in f (Eq. 15): ``sum g * ln2 * (x - xq)``
    down to f's shape, in float32.  ``xq`` is cast to x's dtype and back
    first, as the JAX backward does."""
    xq = hgq_quantize_ref(x, f)
    delta = x.to(torch.float32) - xq.to(torch.float32)
    df = g.to(torch.float32) * LN2 * delta
    return df.sum_to_size(f.shape).to(torch.float32)


def hgq_quantize_group_ref(xs: Sequence[torch.Tensor],
                           fs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The grouped forward's plain version: ``hgq_quantize_ref`` member by
    member."""
    return [hgq_quantize_ref(x, f) for x, f in zip(xs, fs)]
