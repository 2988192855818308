"""PyTorch / CUDA port of the HGQ serving path (``repro``'s counterpart).

Layout mirrors ``src/repro`` module for module.  The package imports
``torch`` and never ``jax`` nor ``repro``; its entry points run on the
CUDA card unless the caller passes ``device="cpu"`` (``device.py``).

Slice 1 covers packed-weight continuous-batching serving of the dense LM
with a quantized KV cache, on three hand-written Hopper kernels
(``kernels/csrc``): ``qmatmul``, ``kv_quantize_rows`` and
``kv_attention_rows``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
