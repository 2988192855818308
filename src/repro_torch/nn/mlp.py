"""Quantized MLP blocks: gated (llama-style) and plain two-layer
(counterpart of ``repro/nn/mlp.py``)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..core.hgq import Aux, QTensor
from .basic import HDense
from .common import HGQConfig


class GLUMLP:
    """gate / up / down with silu (SwiGLU)."""

    @staticmethod
    def init(gen, d: int, d_ff: int, qcfg: HGQConfig, device=None):
        p: Dict[str, Any] = {}
        q: Dict[str, Any] = {}
        p["gate"], q["gate"] = HDense.init(gen, d, d_ff, qcfg, bias=False,
                                           device=device)
        p["up"], q["up"] = HDense.init(gen, d, d_ff, qcfg, bias=False,
                                       device=device)
        p["down"], q["down"] = HDense.init(gen, d_ff, d, qcfg, bias=False,
                                           out_q=False, device=device)
        return p, q

    @staticmethod
    def apply(p, q, x: QTensor, *, mode: str, aux: Optional[Aux],
              act: str = "silu",
              weights: Optional[Dict[str, Dict[str, QTensor]]] = None
              ) -> Tuple[QTensor, Dict[str, Any]]:
        """``weights``: each projection's quantized kernel, made beforehand
        (``HDense.apply``'s ``wq``, by projection name)."""
        w = weights or {}
        newq: Dict[str, Any] = {}
        g, newq["gate"] = HDense.apply(p["gate"], q["gate"], x, mode=mode,
                                       aux=aux, act=act, wq=w.get("gate"))
        u, newq["up"] = HDense.apply(p["up"], q["up"], x, mode=mode, aux=aux,
                                     wq=w.get("up"))
        h = g.q * u.q
        # product of two quantized values: bits add (fixed-point multiply)
        bits = None if g.bits is None or u.bits is None else g.bits + u.bits
        y, newq["down"] = HDense.apply(p["down"], q["down"], QTensor(h, bits),
                                       mode=mode, aux=aux, wq=w.get("down"))
        return y, newq


class MLP:
    """Plain act(x W1 + b) W2 + b (Whisper)."""

    @staticmethod
    def init(gen, d: int, d_ff: int, qcfg: HGQConfig, *, bias: bool = True,
             device=None):
        p: Dict[str, Any] = {}
        q: Dict[str, Any] = {}
        p["fc1"], q["fc1"] = HDense.init(gen, d, d_ff, qcfg, bias=bias,
                                         device=device)
        p["fc2"], q["fc2"] = HDense.init(gen, d_ff, d, qcfg, bias=bias,
                                         out_q=False, device=device)
        return p, q

    @staticmethod
    def apply(p, q, x: QTensor, *, mode: str, aux: Optional[Aux],
              act: str = "gelu") -> Tuple[QTensor, Dict[str, Any]]:
        newq: Dict[str, Any] = {}
        h, newq["fc1"] = HDense.apply(p["fc1"], q["fc1"], x, mode=mode,
                                      aux=aux, act=act)
        y, newq["fc2"] = HDense.apply(p["fc2"], q["fc2"], h, mode=mode,
                                      aux=aux)
        return y, newq
