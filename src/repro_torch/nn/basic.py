"""Basic quantized layers: dense, embedding, norms, activations
(counterpart of ``repro/nn/basic.py``; ``HConv2D`` waits for the port
of the SVHN model)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import hgq
from ..core.hgq import Aux, QTensor
from ..core.quantizer import f_shape_for
from ..dist.perf import is_packed, packed_mantissas, packed_storage
from ..kernels.qmatmul.ops import qmatmul_any
from .common import HGQConfig, act_q_init, apply_act_q, get_qw, qweight_init


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if not name or name == "linear":
        return x
    return {"relu": torch.relu, "silu": F.silu,
            "gelu": lambda v: F.gelu(v, approximate="tanh"),
            "tanh": torch.tanh, "sigmoid": torch.sigmoid,
            "softmax": lambda v: torch.softmax(v, dim=-1)}[name](x)


def _out_quant(p, q, y, mode, aux) -> Tuple[QTensor, Dict[str, Any]]:
    newq = dict(q) if q else {}
    if "out_f" in p:
        yq, st = apply_act_q(y, p["out_f"], q.get("out"), mode, aux)
        if st is not None:
            newq["out"] = st
        return yq, newq
    return QTensor(y, None), newq


class HDense:
    """Quantized kernel (+bias), ~EBOPs on x @ W, optional activation and
    output quantizer.  A serving-packed kernel goes through the
    ``qmatmul`` kernel."""

    @staticmethod
    def init(gen, d_in: int, d_out: int, cfg: HGQConfig, *, bias: bool = True,
             out_q: bool = True, device=None):
        p: Dict[str, Any] = {"kernel": qweight_init(gen, (d_in, d_out), cfg,
                                                    device=device)}
        q: Dict[str, Any] = {}
        if bias:
            p["bias"] = {"w": torch.zeros((d_out,), device=device)}
            if cfg.enabled:
                p["bias"]["f"] = torch.full(
                    f_shape_for((d_out,), cfg.weight_gran),
                    cfg.init_weight_f, dtype=torch.float32, device=device)
        if out_q:
            f, st = act_q_init(cfg, device=device)
            if f is not None:
                p["out_f"] = f
                q["out"] = st
        return p, q

    @staticmethod
    def apply(p, q, x: QTensor, *, mode: str, aux: Optional[Aux],
              act: str = "", wq: Optional[Dict[str, QTensor]] = None
              ) -> Tuple[QTensor, Dict[str, Any]]:
        """``wq``: the kernel's and the bias's quantized weights, made
        beforehand (``common.quantize_weights``, one grouped launch for a
        model's weights); without it they are quantized here."""
        kern = p["kernel"]
        if is_packed(kern):
            # serving hot path: the stored mantissas (int8 or nibbles)
            # stream into the kernel as they lie
            ki, nib = packed_storage(kern)
            y = qmatmul_any(x.q.to(torch.float32), ki,
                            kern["scale"].reshape(ki.shape[-1]), nib=nib
                            ).to(x.q.dtype)
        else:
            kq = wq["kernel"] if wq is not None else get_qw(kern, mode)
            d_in, d_out = kq.q.shape
            y = torch.matmul(x.q.to(kq.q.dtype), kq.q).to(x.q.dtype)
            hgq.matmul_ebops(aux, x.bits, kq.bits, d_in, d_out)
        if "bias" in p:
            y = y + (wq["bias"] if wq is not None
                     else get_qw(p["bias"], mode)).q
        return _out_quant(p, q, activation(act, y), mode, aux)


class HEmbedding:
    """Lookup (no multipliers, no EBOPs) into a quantized table."""

    @staticmethod
    def init(gen, vocab: int, d: int, cfg: HGQConfig, device=None):
        return {"table": qweight_init(gen, (vocab, d), cfg, channel_axis=-1,
                                      scale=0.02, device=device)}, {}

    @staticmethod
    def apply(p, q, ids: torch.Tensor, *, mode: str, aux: Optional[Aux]):
        tbl = p["table"]
        if is_packed(tbl):
            # gather the mantissa rows, then scale them: the same numbers
            # as dequantizing the whole table, without touching it
            if "w_int8" in tbl:
                rows = tbl["w_int8"][ids]
            else:
                rows = packed_mantissas(tbl)[ids]
            y = rows.to(torch.float32) * \
                tbl["scale"].reshape(tbl["scale"].shape[-1])
        else:
            y = get_qw(tbl, mode).q[ids]
        return QTensor(y, None), (dict(q) if q else {})


class RMSNorm:
    @staticmethod
    def init(gen, d: int, cfg: HGQConfig, *, out_q: bool = True, device=None):
        del gen
        p = {"scale": torch.ones((d,), device=device)}
        q: Dict[str, Any] = {}
        if out_q:
            f, st = act_q_init(cfg, device=device)
            if f is not None:
                p["out_f"] = f
                q["out"] = st
        return p, q

    @staticmethod
    def apply(p, q, x: torch.Tensor, *, mode: str, aux: Optional[Aux],
              eps: float = 1e-6):
        xf = x.to(torch.float32)
        y = xf * torch.rsqrt(_mean_sq(xf) + eps)
        y = (y * p["scale"]).to(x.dtype)
        return _out_quant(p, q, y, mode, aux)


def _mean_sq(xf: torch.Tensor) -> torch.Tensor:
    """Mean of squares over the last axis, rounded to float32.

    The card's float32 reduction picks its summation tree by the number
    of rows, so a row's mean would depend on the batch it rides in (a
    decode tick of 8 slots vs one request's prefill) and an activation
    quantizer downstream can round it across a grid point.  The squares
    (exact in float64) are summed in float64 and rounded once, which
    makes each row's result independent of the batch, and the same on
    the card and on the CPU."""
    xd = xf.to(torch.float64)
    return torch.mean(xd * xd, dim=-1, keepdim=True).to(torch.float32)


class LayerNorm:
    @staticmethod
    def init(gen, d: int, cfg: HGQConfig, *, out_q: bool = True, device=None):
        del gen
        p = {"scale": torch.ones((d,), device=device),
             "bias": torch.zeros((d,), device=device)}
        q: Dict[str, Any] = {}
        if out_q:
            f, st = act_q_init(cfg, device=device)
            if f is not None:
                p["out_f"] = f
                q["out"] = st
        return p, q

    @staticmethod
    def apply(p, q, x: torch.Tensor, *, mode: str, aux: Optional[Aux],
              eps: float = 1e-5):
        xf = x.to(torch.float32)
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = (y * p["scale"] + p["bias"]).to(x.dtype)
        return _out_quant(p, q, y, mode, aux)
