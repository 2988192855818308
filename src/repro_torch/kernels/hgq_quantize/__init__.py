"""The HGQ quantizer (Eq. 4) with its Algorithm-1 gradient: the training
path's quantizer kernel, forward (one tensor, or a group in one launch)
and backward."""
from .ops import (LAYOUTS, hgq_quantize, hgq_quantize_bwd, hgq_quantize_fwd,
                  hgq_quantize_fwd_group, hgq_quantize_group, layout_of)
from .ref import (hgq_quantize_grad_ref, hgq_quantize_group_ref,
                  hgq_quantize_ref)

__all__ = ["LAYOUTS", "hgq_quantize", "hgq_quantize_bwd", "hgq_quantize_fwd",
           "hgq_quantize_fwd_group", "hgq_quantize_grad_ref",
           "hgq_quantize_group", "hgq_quantize_group_ref", "hgq_quantize_ref",
           "layout_of"]
