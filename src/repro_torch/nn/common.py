"""Shared plumbing of the quantized layer library (counterpart of
``repro/nn/common.py``).

Layers are functions over nested-dict params.  A quantizable weight is
stored as ``{'w': tensor, 'f': frac-bit tensor}``; a quantized activation
has a trainable ``f`` in params and an ``ActState`` in the separate
``qstate`` tree.  ``init`` takes an explicit ``torch.Generator`` and
device; ``apply(p, q, x, *, mode, aux) -> (y, new_qstate)``.  ``aux=None``
skips the ~EBOPs / L1 bookkeeping (a decode step that nobody reads it
from).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import hgq
from ..core.hgq import ActState, Aux, QTensor
from ..core.quantizer import f_shape_for


@dataclasses.dataclass(frozen=True)
class HGQConfig:
    """Per-model quantization policy."""
    enabled: bool = True
    weight_gran: str = "per_parameter"   # paper tasks; LLMs use per_channel
    act_gran: str = "per_tensor"
    init_weight_f: float = 2.0
    init_act_f: float = 2.0

    def off(self) -> "HGQConfig":
        return dataclasses.replace(self, enabled=False)


FP_BASELINE = HGQConfig(enabled=False)


def uniform_init(gen: torch.Generator, shape, scale=None,
                 device=None) -> torch.Tensor:
    """LeCun-uniform, U(-sqrt(3 / fan_in), +sqrt(3 / fan_in)), or
    U(-scale, scale) when ``scale`` is given."""
    fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
    if len(shape) == 4:  # conv kernel [kh, kw, cin, cout]
        fan_in = shape[0] * shape[1] * shape[2]
    limit = scale if scale is not None else (3.0 / fan_in) ** 0.5
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        -limit, limit, generator=gen)


def qweight_init(gen: torch.Generator, shape, cfg: HGQConfig,
                 channel_axis: int = -1, scale: float = None,
                 device=None) -> Dict[str, Any]:
    p = {"w": uniform_init(gen, shape, scale, device)}
    if cfg.enabled:
        p["f"] = torch.full(f_shape_for(shape, cfg.weight_gran, channel_axis),
                            cfg.init_weight_f, dtype=torch.float32,
                            device=device)
    return p


def act_q_init(cfg: HGQConfig, feature_shape=(), device=None
               ) -> Tuple[Optional[torch.Tensor], Optional[ActState]]:
    """(f param or None, range state or None) for one activation
    quantizer."""
    if not cfg.enabled:
        return None, None
    f_sh = f_shape_for(feature_shape, cfg.act_gran) if feature_shape else ()
    f = torch.full(f_sh, cfg.init_act_f, dtype=torch.float32, device=device)
    return f, hgq.init_act_state(f_sh, device)


def get_qw(p: Dict[str, Any], mode: str) -> QTensor:
    """Quantize (or, for a packed weight, dequantize) a stored weight; a
    quantized one is cast to the compute dtype (``dist.perf``)."""
    if "w_int8" in p or "w_nib" in p:
        from ..dist.perf import unpack_weight
        f = p.get("f")
        return QTensor(unpack_weight(p),
                       None if f is None else torch.relu(f.float()) + 1.0)
    from ..dist.perf import cast_for_matmul
    qt = hgq.quant_weight(p["w"], p.get("f"), mode)
    return QTensor(cast_for_matmul(qt.q), qt.bits)


def quantize_weights(ps: Sequence[Dict[str, Any]], mode: str
                     ) -> List[QTensor]:
    """:func:`get_qw` of several stored (unpacked) weights; in TRAIN their
    quantizers run as one group (``hgq.quant_weights``)."""
    from ..dist.perf import cast_for_matmul
    return [QTensor(cast_for_matmul(t.q), t.bits) for t in hgq.quant_weights(
        [p["w"] for p in ps], [p.get("f") for p in ps], mode)]


def apply_act_q(x: torch.Tensor, f: Optional[torch.Tensor],
                state: Optional[ActState], mode: str, aux: Optional[Aux]
                ) -> Tuple[QTensor, Optional[ActState]]:
    return hgq.quant_act(x, f, state, mode, aux)
