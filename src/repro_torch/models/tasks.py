"""The paper's benchmark models built from H-layers (counterpart of
``repro/models/tasks.py``; the jet tagger so far).

* JetTagger -- 16 -> 64 -> 32 -> 32 -> 5 MLP (jet tagging, Table I)

It starts with an input quantizer (the paper's ``HQuantize`` layer,
Listing 2).  Params and qstate keep the JAX trees' keys.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..core import hgq
from ..core.hgq import Aux, QTensor
from ..device import resolve_device
from ..nn.basic import HDense
from ..nn.common import (HGQConfig, act_q_init, apply_act_q,
                         quantize_weights)


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
        f, st = act_q_init(cfg, (d_in,) if cfg.act_gran != "per_tensor"
                           else (), device=dev)
        if f is not None:
            p["inp_f"] = f
            q["inp"] = st
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
        if "inp_f" in p:
            h, newq["inp"] = apply_act_q(x, p["inp_f"], q.get("inp"), mode,
                                         aux)
        else:
            h = QTensor(x, None)
        layers = [f"d{i}" for i in range(len(JetTagger.WIDTHS))]
        wq = {name: None for name in layers}
        if mode == hgq.TRAIN:
            # every weight and bias quantizer of the step in one group (one
            # kernel launch on the card): none depends on an activation
            keys = [(name, k) for name in layers for k in ("kernel", "bias")
                    if k in p[name]]
            qs = quantize_weights([p[name][k] for name, k in keys], mode)
            wq = {name: {} for name in layers}
            for (name, k), t in zip(keys, qs):
                wq[name][k] = t
        last = len(layers) - 1
        for i, name in enumerate(layers):
            h, newq[name] = HDense.apply(p[name], q[name], h, mode=mode,
                                         aux=aux, wq=wq[name],
                                         act="relu" if i < last else "")
        return h.q, newq, aux
