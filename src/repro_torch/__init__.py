"""PyTorch / CUDA port of HGQ (``repro``'s counterpart).

Layout mirrors ``src/repro`` module for module.  The package imports
``torch`` and never ``jax`` nor ``repro``; its entry points run on the
CUDA card unless the caller passes ``device="cpu"`` (``device.py``).

Ported so far, on the hand-written Hopper kernels of ``kernels/csrc``
(one for each Pallas kernel of the JAX package):

* packed-weight continuous-batching serving of the dense LM with a
  quantized KV cache (``qmatmul``, ``kv_quantize_store``,
  ``kv_attention_rows``);
* HGQ quantization-aware training of the paper's three models (the jet
  tagger, the SVHN conv net, the muon tracker), with calibration and the
  fixed-point proxy (``hgq_quantize``, forward and backward);
* data-parallel training over the compressed gradient wire
  (``wire_pack``);
* the run-configuration surface (``api``: ``RunSpec``, ``build``,
  ``RunContext``) and the training launcher (``python -m
  repro_torch.launch.train``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
