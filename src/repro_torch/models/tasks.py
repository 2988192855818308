"""The paper's three benchmark models (Tables I-III) built from H-layers
with per-parameter granularity (counterpart of ``repro/models/tasks.py``).

* JetTagger   -- 16 -> 64 -> 32 -> 32 -> 5 MLP (jet tagging, Table I)
* SVHNNet     -- LeNet-like conv net (SVHN classifier, Table II)
* MuonTracker -- multistage dense regression (Table III)

Each model starts with an input quantizer (the paper's ``HQuantize``
layer, Listing 2).  Params and qstate keep the JAX trees' keys (and its
HWIO conv kernels and NHWC images).  In TRAIN a model's weight and bias
quantizers run as one group (one ``hgq_quantize`` forward launch on the
card): none depends on an activation.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from ..core import hgq
from ..core.hgq import Aux, QTensor
from ..device import resolve_device
from ..nn.basic import HConv2D, HDense
from ..nn.common import (HGQConfig, act_q_init, apply_act_q,
                         quantize_weights)


def _input_q(cfg: HGQConfig, feature_shape=(), device=None):
    return act_q_init(cfg, feature_shape, device=device)


def _init_input_q(p, q, cfg: HGQConfig, feature_shape=(), device=None):
    f, st = _input_q(cfg, feature_shape, device)
    if f is not None:
        p["inp_f"] = f
        q["inp"] = st


def _apply_input_q(p, q, x, mode, aux, newq) -> QTensor:
    if "inp_f" not in p:
        return QTensor(x, None)
    h, newq["inp"] = apply_act_q(x, p["inp_f"], q.get("inp"), mode, aux)
    return h


def _weights(p, layers: Sequence[str], mode: str) -> Dict[str, Any]:
    """{layer: its quantized kernel and bias} made in one group in TRAIN,
    {layer: None} (each layer quantizes its own) otherwise."""
    if mode != hgq.TRAIN:
        return {name: None for name in layers}
    keys = [(name, k) for name in layers for k in ("kernel", "bias")
            if k in p[name]]
    qs = quantize_weights([p[name][k] for name, k in keys], mode)
    wq: Dict[str, Any] = {name: {} for name in layers}
    for (name, k), t in zip(keys, qs):
        wq[name][k] = t
    return wq


class JetTagger:
    WIDTHS = (64, 32, 32, 5)

    @staticmethod
    def init(gen: torch.Generator, cfg: HGQConfig, d_in: int = 16,
             device=None):
        """(params, qstate) on ``device`` (the card by default), weights
        drawn from ``gen``, which lives on that device."""
        dev = resolve_device(device)
        p: Dict[str, Any] = {}
        q: Dict[str, Any] = {}
        _init_input_q(p, q, cfg, (d_in,) if cfg.act_gran != "per_tensor"
                      else (), dev)
        din = d_in
        last = len(JetTagger.WIDTHS) - 1
        for i, w in enumerate(JetTagger.WIDTHS):
            p[f"d{i}"], q[f"d{i}"] = HDense.init(gen, din, w, cfg,
                                                 out_q=i < last, device=dev)
            din = w
        return p, q

    @staticmethod
    def forward(p, q, batch, mode: str = hgq.TRAIN):
        """(logits [B, 5], new qstate, Aux) for ``batch['x']`` [B, 16]."""
        x = batch["x"]
        aux = Aux.zero(x.device)
        newq: Dict[str, Any] = {}
        h = _apply_input_q(p, q, x, mode, aux, newq)
        layers = [f"d{i}" for i in range(len(JetTagger.WIDTHS))]
        wq = _weights(p, layers, mode)
        last = len(layers) - 1
        for i, name in enumerate(layers):
            h, newq[name] = HDense.apply(p[name], q[name], h, mode=mode,
                                         aux=aux, wq=wq[name],
                                         act="relu" if i < last else "")
        return h.q, newq, aux


class SVHNNet:
    """conv16-conv16-conv24 (each VALID, relu, then a 2x2 VALID max-pool)
    -> dense 42 -> dense 64 -> 10."""

    CONVS = ("c0", "c1", "c2")
    DENSES = ("d0", "d1", "d2")

    @staticmethod
    def init(gen: torch.Generator, cfg: HGQConfig, img: int = 32,
             cin: int = 3, device=None):
        """(params, qstate) on ``device`` (the card by default)."""
        del img  # the flattened width below is the 32x32 input's
        dev = resolve_device(device)
        p: Dict[str, Any] = {}
        q: Dict[str, Any] = {}
        _init_input_q(p, q, cfg, device=dev)
        for name, ci, co in (("c0", cin, 16), ("c1", 16, 16), ("c2", 16, 24)):
            p[name], q[name] = HConv2D.init(gen, 3, 3, ci, co, cfg,
                                            device=dev)
        # 32x32 -> conv(30) pool(15) -> conv(13) pool(6) -> conv(4) pool(2)
        flat = 2 * 2 * 24
        for name, di, do in (("d0", flat, 42), ("d1", 42, 64)):
            p[name], q[name] = HDense.init(gen, di, do, cfg, device=dev)
        p["d2"], q["d2"] = HDense.init(gen, 64, 10, cfg, out_q=False,
                                       device=dev)
        return p, q

    @staticmethod
    def forward(p, q, batch, mode: str = hgq.TRAIN):
        """(logits [B, 10], new qstate, Aux) for ``batch['x']`` [B, 32, 32,
        3] (NHWC)."""
        x = batch["x"]
        aux = Aux.zero(x.device)
        newq: Dict[str, Any] = {}
        h = _apply_input_q(p, q, x, mode, aux, newq)
        wq = _weights(p, SVHNNet.CONVS + SVHNNet.DENSES, mode)
        for name in SVHNNet.CONVS:
            h, newq[name] = HConv2D.apply(p[name], q[name], h, mode=mode,
                                          aux=aux, act="relu", wq=wq[name])
            # the reference's reduce_window(max, -inf) over 2x2 VALID
            # windows: the same floor of odd sizes, the first maximum of a
            # window takes the gradient in both
            pooled = F.max_pool2d(h.q.permute(0, 3, 1, 2), 2, 2)
            h = QTensor(pooled.permute(0, 2, 3, 1), h.bits)
        B = h.q.shape[0]
        h = QTensor(h.q.reshape(B, -1),
                    None if h.bits is None else torch.amax(h.bits))
        for name in SVHNNet.DENSES:
            h, newq[name] = HDense.apply(p[name], q[name], h, mode=mode,
                                         aux=aux, wq=wq[name],
                                         act="relu" if name != "d2" else "")
        return h.q, newq, aux


class MuonTracker:
    """Three detector stations (3x50 binary hit maps) -> per-station dense
    encoders -> concatenated trunk -> angle (mrad) regression."""

    STATION_WIDTH = 32
    TRUNK = (64, 32)
    LAYERS = ("s0", "s1", "s2", "t0", "t1", "out")

    @staticmethod
    def init(gen: torch.Generator, cfg: HGQConfig, device=None):
        """(params, qstate) on ``device`` (the card by default)."""
        dev = resolve_device(device)
        p: Dict[str, Any] = {}
        q: Dict[str, Any] = {}
        _init_input_q(p, q, cfg, device=dev)
        for i in range(3):
            p[f"s{i}"], q[f"s{i}"] = HDense.init(
                gen, 150, MuonTracker.STATION_WIDTH, cfg, device=dev)
        din = 3 * MuonTracker.STATION_WIDTH
        for j, w in enumerate(MuonTracker.TRUNK):
            p[f"t{j}"], q[f"t{j}"] = HDense.init(gen, din, w, cfg,
                                                 device=dev)
            din = w
        p["out"], q["out"] = HDense.init(gen, din, 1, cfg, out_q=False,
                                         device=dev)
        return p, q

    @staticmethod
    def forward(p, q, batch, mode: str = hgq.TRAIN):
        """(angle [B] in mrad, new qstate, Aux) for ``batch['stations']``
        [B, 3, 150] (flattened 3x50 hit maps)."""
        x = batch["stations"]
        aux = Aux.zero(x.device)
        newq: Dict[str, Any] = {}
        xq = _apply_input_q(p, q, x, mode, aux, newq)
        wq = _weights(p, MuonTracker.LAYERS, mode)
        outs = []
        for i in range(3):
            hi, newq[f"s{i}"] = HDense.apply(
                p[f"s{i}"], q[f"s{i}"], QTensor(xq.q[:, i], xq.bits),
                mode=mode, aux=aux, act="relu", wq=wq[f"s{i}"])
            outs.append(hi)
        bits = None
        if outs[0].bits is not None:
            bits = torch.amax(torch.stack([torch.amax(o.bits)
                                           for o in outs]))
        h = QTensor(torch.cat([o.q for o in outs], dim=-1), bits)
        for j in range(len(MuonTracker.TRUNK)):
            h, newq[f"t{j}"] = HDense.apply(p[f"t{j}"], q[f"t{j}"], h,
                                            mode=mode, aux=aux, act="relu",
                                            wq=wq[f"t{j}"])
        h, newq["out"] = HDense.apply(p["out"], q["out"], h, mode=mode,
                                      aux=aux, wq=wq["out"])
        return h.q[..., 0], newq, aux
