"""Basic quantized layers: dense, conv2d, embedding, norms, activations
(counterpart of ``repro/nn/basic.py``)."""
from __future__ import annotations

import types
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import ebops as ebops_lib
from ..core import hgq
from ..core.hgq import Aux, QTensor
from ..core.quantizer import f_shape_for
from ..dist.perf import (get_packed_matmul, is_packed, packed_mantissas,
                         packed_storage)
from ..kernels._work import io_work, kernel_op
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
    ``qmatmul`` kernel where the packed routing is on
    (``dist.perf.packed_matmul``), else it is dequantized."""

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
        if is_packed(kern) and get_packed_matmul():
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


# cuDNN as the conv uses it, forward and backward: full float32 (PyTorch's
# default lets cuDNN run float32 convs in TF32, ~10 mantissa bits, which
# puts the card ~1e-3 off the CPU) and deterministic algorithms (two runs
# give the same bits)
CUDNN_FLAGS = types.MappingProxyType(dict(
    enabled=True, benchmark=False, deterministic=True, allow_tf32=False))


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` (no padding, no bias) whose forward and backward both
    run under ``CUDNN_FLAGS``, whatever the caller set globally."""

    @staticmethod
    def forward(ctx, x, w, stride):
        with torch.backends.cudnn.flags(**CUDNN_FLAGS):
            y = F.conv2d(x, w, stride=stride)
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.backends.cudnn.flags(**CUDNN_FLAGS):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g.contiguous(memory_format=torch.channels_last), x, w, None,
                [ctx.stride] * 2, [0, 0], [1, 1], False, [0, 0], 1,
                [need[0], need[1], False])
        return gx, gw, None


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (low, high)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: str = "VALID") -> torch.Tensor:
    """``lax.conv_general_dilated`` with NHWC x, HWIO w and NHWC output,
    on permuted views (channels-last memory throughout), in full float32
    on the card (``CUDNN_FLAGS``).  ``padding``: "VALID" or "SAME"."""
    if padding == "SAME":
        (ht, hb), (wl, wr) = (_same_pads(x.shape[1], w.shape[0], stride),
                              _same_pads(x.shape[2], w.shape[1], stride))
        x = F.pad(x, (0, 0, wl, wr, ht, hb))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'VALID' or 'SAME', got {padding!r}")
    y = _Conv2d.apply(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride)
    return y.permute(0, 2, 3, 1)


def _chan_bits(bits: torch.Tensor, cin: int) -> torch.Tensor:
    """Collapse activation bits to per-input-channel for conv ~EBOPs."""
    b = torch.as_tensor(bits, dtype=torch.float32)
    if b.ndim == 0:
        return b
    if b.shape[-1] == cin:
        return torch.amax(b.reshape(-1, b.shape[-1]), dim=0)
    return torch.amax(b).reshape(1)


class HConv2D:
    """Quantized conv kernel [kh, kw, cin, cout] (HWIO, as the reference
    keeps it) over NHWC activations, +bias, stream-IO ~EBOPs, optional
    activation and output quantizer.  The conv (``conv2d_nhwc``) runs in
    full float32 with deterministic cuDNN algorithms on the card, forward
    and backward, under the layer's own ``CUDNN_FLAGS`` and not the
    caller's global ones: PyTorch's default TF32 would put the card ~1e-3
    off the CPU."""

    @staticmethod
    def init(gen, kh: int, kw: int, cin: int, cout: int, cfg: HGQConfig, *,
             bias: bool = True, out_q: bool = True, device=None):
        p: Dict[str, Any] = {"kernel": qweight_init(gen, (kh, kw, cin, cout),
                                                    cfg, device=device)}
        q: Dict[str, Any] = {}
        if bias:
            p["bias"] = {"w": torch.zeros((cout,), device=device)}
            if cfg.enabled:
                p["bias"]["f"] = torch.full(
                    f_shape_for((cout,), cfg.weight_gran),
                    cfg.init_weight_f, dtype=torch.float32, device=device)
        if out_q:
            f, st = act_q_init(cfg, device=device)
            if f is not None:
                p["out_f"] = f
                q["out"] = st
        return p, q

    @staticmethod
    def apply(p, q, x: QTensor, *, mode: str, aux: Optional[Aux],
              act: str = "", stride: int = 1, padding: str = "VALID",
              wq: Optional[Dict[str, QTensor]] = None
              ) -> Tuple[QTensor, Dict[str, Any]]:
        """``wq``: the quantized kernel and bias, made beforehand (as
        ``HDense.apply`` takes them)."""
        kq = wq["kernel"] if wq is not None else get_qw(p["kernel"], mode)
        w_shape = tuple(p["kernel"]["w"].shape)
        y = conv2d_nhwc(x.q, kq.q, stride, padding)
        if aux is not None and x.bits is not None and kq.bits is not None:
            aux.add(ebops=ebops_lib.ebops_conv2d(
                _chan_bits(x.bits, w_shape[2]), kq.bits, w_shape))
        if "bias" in p:
            y = y + (wq["bias"] if wq is not None
                     else get_qw(p["bias"], mode)).q
        return _out_quant(p, q, activation(act, y), mode, aux)


class _Gather(torch.autograd.Function):
    """``table[ids]`` whose backward sums each row's gradients in a fixed
    order: the ids sorted (stably, so a row's gradients keep the tokens'
    order), one segmented sum a distinct id, written into a zero table.
    No atomics: two runs on the card give the same bits, where the
    accumulating ``index_put`` of ``table[ids]``'s own backward adds in
    no fixed order."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        return _table_grad(g, ids, ctx.rows), None


def _table_grad_work(out, g, ids, rows):
    """The table gradient's work (``kernels._work``): no matmul; the
    gradients and ids read, the whole [rows, d] table written."""
    return io_work(out, g, ids)


def _zero_table(g, ids, rows):
    return torch.zeros((rows, g.shape[-1]), dtype=g.dtype, device=g.device)


@kernel_op("embedding_grad", _table_grad_work, meta=_zero_table)
def _table_grad(g: torch.Tensor, ids: torch.Tensor, rows: int
                ) -> torch.Tensor:
    """``[rows, d]`` gradient of a gather of ``ids``: the segmented sums,
    whose segments depend on the ids (on ``meta``, where there are none,
    a table of the right shape)."""
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    uniq, counts = torch.unique_consecutive(flat[order],
                                            return_counts=True)
    sums = torch.segment_reduce(g.reshape(-1, g.shape[-1])[order], "sum",
                                lengths=counts, axis=0)
    out = _zero_table(g, ids, rows)
    out[uniq] = sums
    return out


class HEmbedding:
    """Lookup (no multipliers, no EBOPs) into a quantized table; in TRAIN
    the table's gradient is summed in a fixed order (``_Gather``)."""

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
            y = _Gather.apply(get_qw(tbl, mode).q, ids)
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
        """The reference's ``mu``, ``mean((x - mu)^2)``, ``rsqrt(var +
        eps)``, each mean summed in float64 and rounded once to float32
        (as ``_mean_sq``: a row's result then does not depend on its
        batch, on the card or on the CPU)."""
        xf = x.to(torch.float32)
        mu = torch.mean(xf.to(torch.float64), dim=-1,
                        keepdim=True).to(torch.float32)
        var = _mean_sq(xf - mu)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = (y * p["scale"] + p["bias"]).to(x.dtype)
        return _out_quant(p, q, y, mode, aux)
