"""PyTorch / CUDA port of HGQ (``repro``'s counterpart).

Layout mirrors ``src/repro`` module for module.  The package imports
``torch`` and never ``jax`` nor ``repro``; its entry points run on the
CUDA card unless the caller passes ``device="cpu"`` (``device.py``).

Ported so far, on four hand-written Hopper kernels (``kernels/csrc``):

* packed-weight continuous-batching serving of the dense LM with a
  quantized KV cache (``qmatmul``, ``kv_quantize_rows``,
  ``kv_attention_rows``);
* HGQ quantization-aware training of the paper's jet tagger, with
  calibration and the fixed-point proxy (``hgq_quantize``, forward and
  backward).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
