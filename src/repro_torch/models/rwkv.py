"""RWKV-6 (Finch) language model, attention-free with O(1) state a slot
(counterpart of ``repro/models/rwkv.py``).

Params keep the reference's tree: the layers stacked ``[L, ...]`` under
``layers/{ln1,att,ln2,ffn}``, so plan keys (``layers/ffn/wk/kernel``),
``from_jax`` and the packing walker carry over unchanged.  The
reference's ``lax.scan`` over the stacked layers becomes a loop over
per-layer views (``layer_views``), as ``TransformerLM`` loops over its
layers; with ``cfg.remat`` (and autograd on) each layer is recomputed in
its backward, as the reference checkpoints its scan body.  The
reference's sharding constraints are left out: the port has no model
axis.

Decode writes each layer's new ``shift_a``, ``shift_f`` and WKV state
into the ``[L, B, ...]`` caches in place; the caches object is returned
as given.  The model holds no KV cache, so ``kv_bits`` changes nothing.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core import hgq
from ..core.hgq import Aux
from ..device import resolve_device
from ..nn.basic import HDense, HEmbedding, LayerNorm
from ..nn.recurrent import (RWKVChannelMix, RWKVConfig, RWKVState,
                            RWKVTimeMix)
from ..tree import tree_map
from .config import ModelConfig
from .lm import layer_views


class RWKVCaches(NamedTuple):
    shift_a: torch.Tensor   # [L, B, d]
    shift_f: torch.Tensor   # [L, B, d]
    wkv: torch.Tensor       # [L, B, H, N, N]


def _rwkv_cfg(cfg: ModelConfig) -> RWKVConfig:
    # heads of 64 channels, as the reference writes it (not cfg.n_heads)
    return RWKVConfig(d_model=cfg.d_model, n_heads=cfg.d_model // 64,
                      d_ff=cfg.d_ff, time_chunk=cfg.rwkv_chunk)


def _layers(tree, cfg: ModelConfig):
    """The layers' per-layer trees: ``tree["layers"]`` itself where it is
    a list of views already (``serving_views``), else its views."""
    ls = tree["layers"]
    return ls if isinstance(ls, list) else layer_views(ls, cfg.n_layers)


class RWKVLM:
    """Static ``init`` / ``forward`` / ``init_cache`` / ``decode_step``
    over explicit trees, as ``TransformerLM``'s."""

    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig, device=None):
        """Seeded init with the reference's distributions (its numbers
        differ: ``torch.Generator`` is not ``jax.random``)."""
        dev = resolve_device(device)
        rc = _rwkv_cfg(cfg)
        p: Dict[str, Any] = {}
        q: Dict[str, Any] = {}
        p["embed"], q["embed"] = HEmbedding.init(gen, cfg.vocab, cfg.d_model,
                                                 cfg.hgq, dev)
        per_p, per_q = [], []
        for _ in range(cfg.n_layers):
            lp: Dict[str, Any] = {}
            lq: Dict[str, Any] = {}
            lp["ln1"], lq["ln1"] = LayerNorm.init(gen, cfg.d_model, cfg.hgq,
                                                  device=dev)
            lp["att"], lq["att"] = RWKVTimeMix.init(gen, rc, cfg.hgq, dev)
            lp["ln2"], lq["ln2"] = LayerNorm.init(gen, cfg.d_model, cfg.hgq,
                                                  device=dev)
            lp["ffn"], lq["ffn"] = RWKVChannelMix.init(gen, rc, cfg.hgq, dev)
            per_p.append(lp)
            per_q.append(lq)
        p["layers"] = tree_map(lambda *a: torch.stack(a), *per_p)
        q["layers"] = tree_map(lambda *a: torch.stack(a), *per_q)
        p["final_norm"], q["final_norm"] = LayerNorm.init(
            gen, cfg.d_model, cfg.hgq, device=dev)
        p["lm_head"], q["lm_head"] = HDense.init(gen, cfg.d_model, cfg.vocab,
                                                 cfg.hgq, bias=False,
                                                 out_q=False, device=dev)
        return p, q

    @staticmethod
    def serving_views(tree, cfg: ModelConfig):
        """A params or qstate tree with its stacked layers as per-layer
        views, made once (the engine's tick loops over them)."""
        return {**tree, "layers": _layers(tree, cfg)}

    # ------------------------------------------------------------------
    @staticmethod
    def _layer(lp, lq, h, state: Optional[RWKVState], cfg: ModelConfig,
               mode: str, aux: Optional[Aux]):
        """One layer: (h, new range states, the new ``RWKVState``)."""
        rc = _rwkv_cfg(cfg)
        newq: Dict[str, Any] = {}
        n1, newq["ln1"] = LayerNorm.apply(lp["ln1"], lq["ln1"], h, mode=mode,
                                          aux=aux)
        a, newq["att"], (sa, wkv) = RWKVTimeMix.apply(
            lp["att"], lq["att"], n1, state, cfg=rc, mode=mode, aux=aux)
        x = h + a.q
        n2, newq["ln2"] = LayerNorm.apply(lp["ln2"], lq["ln2"], x, mode=mode,
                                          aux=aux)
        f, newq["ffn"], sf = RWKVChannelMix.apply(
            lp["ffn"], lq["ffn"], n2, None if state is None
            else state.shift_f, mode=mode, aux=aux)
        return (x + f.q).to(h.dtype), newq, RWKVState(sa, sf, wkv)

    @staticmethod
    def _forward_layer(lp, lq, h, cfg: ModelConfig, mode: str):
        """A layer without a cache: (h, new range states, (~EBOPs, L1))."""
        aux = Aux.zero(h.device)
        h, newq, _ = RWKVLM._layer(lp, lq, h, None, cfg, mode, aux)
        return h, newq, aux.as_tuple()

    @staticmethod
    def forward(p, q, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                mode: str = hgq.TRAIN):
        """Training / prefill forward over ``batch["tokens"]`` [B, S] from
        zero states: (logits [B, S, V], new qstate, Aux), the layers'
        ~EBOPs and L1 summed as the reference's scan carry sums them."""
        tokens = batch["tokens"]
        aux = Aux.zero(tokens.device)
        newq: Dict[str, Any] = {}
        e, newq["embed"] = HEmbedding.apply(p["embed"], q["embed"], tokens,
                                            mode=mode, aux=aux)
        x = e.q
        ebops = torch.zeros((), dtype=torch.float32, device=x.device)
        l1 = torch.zeros((), dtype=torch.float32, device=x.device)
        layer_q = []
        for lp, lq in zip(_layers(p, cfg), _layers(q, cfg)):
            args = (lp, lq, x, cfg, mode)
            if cfg.remat and torch.is_grad_enabled():
                x, nq, (eb, a) = checkpoint(RWKVLM._forward_layer, *args,
                                            use_reentrant=False,
                                            preserve_rng_state=False)
            else:
                x, nq, (eb, a) = RWKVLM._forward_layer(*args)
            ebops, l1 = ebops + eb, l1 + a
            layer_q.append(nq)
        newq["layers"] = tree_map(lambda *a: torch.stack(a), *layer_q)
        aux.add(ebops=ebops, l1=l1)
        h, newq["final_norm"] = LayerNorm.apply(p["final_norm"],
                                                q["final_norm"], x, mode=mode,
                                                aux=aux)
        lt, newq["lm_head"] = HDense.apply(p["lm_head"], q["lm_head"], h,
                                           mode=mode, aux=aux)
        return lt.q, newq, aux

    # ------------------------------------------------------------------
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.float32, ring_slack: int = 0,
                   kv_bits: Optional[int] = None,
                   device=None) -> RWKVCaches:
        """Zeroed recurrent states.  ``max_len``, ``ring_slack`` and
        ``kv_bits`` are taken for the engine's sake and change nothing:
        the state is O(1) a slot and there is no KV cache."""
        del max_len, ring_slack, kv_bits
        dev = resolve_device(device)
        d, L = cfg.d_model, cfg.n_layers
        H = d // 64
        return RWKVCaches(
            shift_a=torch.zeros((L, batch, d), dtype=dtype, device=dev),
            shift_f=torch.zeros((L, batch, d), dtype=dtype, device=dev),
            wkv=torch.zeros((L, batch, H, 64, 64), dtype=torch.float32,
                            device=dev))

    @staticmethod
    def decode_step(p, q, caches: RWKVCaches, tokens: torch.Tensor,
                    cache_pos, cfg: ModelConfig, mode: str = hgq.EVAL,
                    kv_bits: Optional[int] = None):
        """One decode step over tokens [B, S_new] (any S_new: a prefill
        chunk runs the chunked WKV over it).  ``cache_pos`` and
        ``kv_bits`` change nothing (no positions, no KV cache).  Writes
        the states in place; returns (logits [B, S_new, V], caches).
        ``p["layers"]`` may be the stacked tree or its per-layer views."""
        del cache_pos, kv_bits
        e, _ = HEmbedding.apply(p["embed"], q["embed"], tokens, mode=mode,
                                aux=None)
        x = e.q
        for i, (lp, lq) in enumerate(zip(_layers(p, cfg), _layers(q, cfg))):
            st = RWKVState(caches.shift_a[i], caches.shift_f[i],
                           caches.wkv[i])
            x, _, ns = RWKVLM._layer(lp, lq, x, st, cfg, mode, None)
            caches.shift_a[i].copy_(ns.shift_a)
            caches.shift_f[i].copy_(ns.shift_f)
            caches.wkv[i].copy_(ns.wkv)
        h, _ = LayerNorm.apply(p["final_norm"], q["final_norm"], x,
                               mode=mode, aux=None)
        lt, _ = HDense.apply(p["lm_head"], q["lm_head"], h, mode=mode,
                             aux=None)
        return lt.q, caches
