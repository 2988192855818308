"""Griffin / RecurrentGemma: RG-LRU recurrent blocks and local attention,
1:2 (counterpart of ``repro/models/griffin.py``).

Pattern: (recurrent, recurrent, attention) repeating; the trailing
remainder layers are recurrent (recurrentgemma-2b: 26 layers = 8 units +
2).  Params keep the reference's tree: the units stacked ``[U, ...]``
under ``units/{rec1,rec2,att}``, the remainder a list under ``rem``, so
plan keys (``rem/0/mix/in_rnn/kernel``), ``from_jax`` and the packing
walker carry over unchanged.  ``lax.scan`` over the units becomes a loop
over per-unit views (``layer_views``), as ``TransformerLM`` loops over
its layers; with ``cfg.remat`` (and autograd on) each unit is recomputed
in its backward, as the reference checkpoints its scan body.  The
reference's sharding constraints are left out: the port has no model
axis.

Decode writes in place: each attention layer's new k / v rows into its
ring (``GQAAttention``), each recurrent layer's conv buffer and hidden
state into ``GriffinCaches.conv`` / ``.h``; the caches object is returned
as given.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core import hgq
from ..core.hgq import Aux
from ..device import resolve_device
from ..nn.attention import (AttnConfig, GQAAttention, KVCache, QKVCache,
                            decode_positions)
from ..nn.basic import HDense, HEmbedding, RMSNorm
from ..nn.mlp import GLUMLP
from ..nn.recurrent import GriffinState, RecurrentBlock, RGLRUConfig
from ..tree import tree_map
from .config import ModelConfig
from .lm import layer_views


class GriffinCaches(NamedTuple):
    conv: torch.Tensor   # [n_rec, B, cw-1, d_rnn]
    h: torch.Tensor      # [n_rec, B, d_rnn]
    k: torch.Tensor      # [n_att, B, W, KV, hd] (int8 mantissas when
    v: torch.Tensor      # quantized; [.., hd//2] nibble-packed <= 4 bits)
    kf: Optional[torch.Tensor] = None   # [n_att, B, W, KV] grid exponents
    vf: Optional[torch.Tensor] = None   # (None = the fp cache)


def _rg_cfg(cfg: ModelConfig) -> RGLRUConfig:
    return RGLRUConfig(d_model=cfg.d_model, d_rnn=cfg.d_model)


def _attn_cfg(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv=cfg.n_kv, head_dim=cfg.hd, rope_theta=10000.0,
                      window=cfg.window, causal=True,
                      q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)


def _layer_counts(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(#pattern units, #remainder recurrent layers, #attention layers)."""
    units = cfg.n_layers // 3
    rem = cfg.n_layers - units * 3
    return units, rem, units


def _units(tree, cfg: ModelConfig):
    """The units' per-unit trees: ``tree["units"]`` itself where it is a
    list of views already (``serving_views``), else its views."""
    u = tree["units"]
    return u if isinstance(u, list) else layer_views(u, _layer_counts(cfg)[0])


class GriffinLM:
    """Static ``init`` / ``forward`` / ``init_cache`` / ``decode_step``
    over explicit trees, as ``TransformerLM``'s."""

    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig, device=None):
        """Seeded init with the reference's distributions (its numbers
        differ: ``torch.Generator`` is not ``jax.random``)."""
        dev = resolve_device(device)
        rg, ac = _rg_cfg(cfg), _attn_cfg(cfg)
        units, rem, _ = _layer_counts(cfg)
        p: Dict[str, Any] = {}
        q: Dict[str, Any] = {}
        p["embed"], q["embed"] = HEmbedding.init(gen, cfg.vocab, cfg.d_model,
                                                 cfg.hgq, dev)

        def block_init(kind: str):
            lp: Dict[str, Any] = {}
            lq: Dict[str, Any] = {}
            lp["ln1"], lq["ln1"] = RMSNorm.init(gen, cfg.d_model, cfg.hgq,
                                                device=dev)
            if kind == "rec":
                lp["mix"], lq["mix"] = RecurrentBlock.init(gen, rg, cfg.hgq,
                                                           dev)
            else:
                lp["mix"], lq["mix"] = GQAAttention.init(gen, ac, cfg.hgq,
                                                         dev)
            lp["ln2"], lq["ln2"] = RMSNorm.init(gen, cfg.d_model, cfg.hgq,
                                                device=dev)
            lp["mlp"], lq["mlp"] = GLUMLP.init(gen, cfg.d_model, cfg.d_ff,
                                               cfg.hgq, dev)
            return lp, lq

        per_p, per_q = [], []
        for _ in range(units):
            blocks = {name: block_init(kind) for name, kind in
                      (("rec1", "rec"), ("rec2", "rec"), ("att", "att"))}
            per_p.append({k: v[0] for k, v in blocks.items()})
            per_q.append({k: v[1] for k, v in blocks.items()})
        p["units"] = tree_map(lambda *a: torch.stack(a), *per_p)
        q["units"] = tree_map(lambda *a: torch.stack(a), *per_q)
        p["rem"], q["rem"] = [], []
        for _ in range(rem):
            bp, bq = block_init("rec")
            p["rem"].append(bp)
            q["rem"].append(bq)
        p["final_norm"], q["final_norm"] = RMSNorm.init(gen, cfg.d_model,
                                                        cfg.hgq, device=dev)
        p["lm_head"], q["lm_head"] = HDense.init(gen, cfg.d_model, cfg.vocab,
                                                 cfg.hgq, bias=False,
                                                 out_q=False, device=dev)
        return p, q

    @staticmethod
    def serving_views(tree, cfg: ModelConfig):
        """A params or qstate tree with its stacked units as per-unit
        views, made once (the engine's tick loops over them)."""
        return {**tree, "units": _units(tree, cfg)}

    # ------------------------------------------------------------------
    @staticmethod
    def _block(lp, lq, x, kind, cfg, mode, aux, positions, rec_state=None,
               kv_cache=None, cache_pos=None, kv_bits=None):
        newq: Dict[str, Any] = {}
        h, newq["ln1"] = RMSNorm.apply(lp["ln1"], lq["ln1"], x, mode=mode,
                                       aux=aux)
        new_state = None
        if kind == "rec":
            m, newq["mix"], new_state = RecurrentBlock.apply(
                lp["mix"], lq["mix"], h, rec_state, cfg=_rg_cfg(cfg),
                mode=mode, aux=aux)
        else:
            m, newq["mix"], _ = GQAAttention.apply(
                lp["mix"], lq["mix"], h, cfg=_attn_cfg(cfg), mode=mode,
                aux=aux, positions=positions, cache=kv_cache,
                cache_pos=cache_pos, kv_bits=kv_bits)
        x = x + m.q
        h, newq["ln2"] = RMSNorm.apply(lp["ln2"], lq["ln2"], x, mode=mode,
                                       aux=aux)
        m, newq["mlp"] = GLUMLP.apply(lp["mlp"], lq["mlp"], h, mode=mode,
                                      aux=aux, act="gelu")
        return x + m.q, newq, new_state

    @staticmethod
    def _unit(up, uq, x, positions, cfg, mode):
        """One (rec, rec, att) unit without a cache: (x, new range states,
        (~EBOPs, L1))."""
        aux = Aux.zero(x.device)
        nq: Dict[str, Any] = {}
        for name, kind in (("rec1", "rec"), ("rec2", "rec"), ("att", "att")):
            x, nq[name], _ = GriffinLM._block(up[name], uq[name], x, kind,
                                              cfg, mode, aux, positions)
        return x, nq, aux.as_tuple()

    @staticmethod
    def _stack_forward(p, q, x, positions, cfg: ModelConfig, mode: str):
        """The no-cache layer loop: (x, new range states -- the units'
        stacked to ``[U, ...]``, the remainder's a list --, Aux summed as
        the reference's scan carry and remainder loop sum it)."""
        ebops = torch.zeros((), dtype=torch.float32, device=x.device)
        l1 = torch.zeros((), dtype=torch.float32, device=x.device)
        newq: Dict[str, Any] = {}
        unit_q = []
        for up, uq in zip(_units(p, cfg), _units(q, cfg)):
            args = (up, uq, x, positions, cfg, mode)
            if cfg.remat and torch.is_grad_enabled():
                h, nq, (e, a) = checkpoint(GriffinLM._unit, *args,
                                           use_reentrant=False,
                                           preserve_rng_state=False)
            else:
                h, nq, (e, a) = GriffinLM._unit(*args)
            x = h.to(x.dtype)
            ebops, l1 = ebops + e, l1 + a
            unit_q.append(nq)
        newq["units"] = tree_map(lambda *a: torch.stack(a), *unit_q)
        aux = Aux(ebops, l1)
        newq["rem"] = []
        for lp, lq in zip(p["rem"], q["rem"]):
            a = Aux.zero(x.device)
            x, nq, _ = GriffinLM._block(lp, lq, x, "rec", cfg, mode, a,
                                        positions)
            newq["rem"].append(nq)
            aux.merge(a)
        return x, newq, aux

    # ------------------------------------------------------------------
    @staticmethod
    def forward(p, q, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                mode: str = hgq.TRAIN):
        """Training / prefill forward over ``batch["tokens"]`` [B, S]
        (positions 0..S-1, no cache): (logits [B, S, V], new qstate,
        Aux)."""
        tokens = batch["tokens"]
        S = tokens.shape[1]
        aux = Aux.zero(tokens.device)
        newq: Dict[str, Any] = {}
        e, newq["embed"] = HEmbedding.apply(p["embed"], q["embed"], tokens,
                                            mode=mode, aux=aux)
        x, nq, aux2 = GriffinLM._stack_forward(
            p, q, e.q, torch.arange(S, device=tokens.device), cfg, mode)
        newq.update(nq)
        aux.merge(aux2)
        h, newq["final_norm"] = RMSNorm.apply(p["final_norm"],
                                              q["final_norm"], x, mode=mode,
                                              aux=aux)
        lt, newq["lm_head"] = HDense.apply(p["lm_head"], q["lm_head"], h,
                                           mode=mode, aux=aux)
        return lt.q, newq, aux

    # ------------------------------------------------------------------
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, ring_slack: int = 0,
                   kv_bits: Optional[int] = None,
                   device=None) -> GriffinCaches:
        """Zeroed recurrent states and ``[n_att, B, W, KV, hd]`` rings;
        ``ring_slack`` as ``TransformerLM.init_cache``'s (multi-token
        chunks stay exact on the local-attention rings); ``kv_bits``
        selects the quantized ring (``serving/kvcache.py``)."""
        dev = resolve_device(device)
        units, rem, natt = _layer_counts(cfg)
        nrec = 2 * units + rem
        W = min(max_len, (cfg.window + ring_slack) if cfg.window
                else max_len)
        rg = _rg_cfg(cfg)
        kv_shape = (natt, batch, W, cfg.n_kv, cfg.hd)
        if kv_bits is not None:
            from ..serving.kvcache import quantized_cache
            kv = quantized_cache(kv_shape, kv_bits, device=dev)._asdict()
        else:
            kv = dict(k=torch.zeros(kv_shape, dtype=dtype, device=dev),
                      v=torch.zeros(kv_shape, dtype=dtype, device=dev))
        return GriffinCaches(
            conv=torch.zeros((nrec, batch, rg.conv_width - 1, rg.d_rnn),
                             dtype=torch.float32, device=dev),
            h=torch.zeros((nrec, batch, rg.d_rnn), dtype=torch.float32,
                          device=dev), **kv)

    @staticmethod
    def decode_step(p, q, caches: GriffinCaches, tokens: torch.Tensor,
                    cache_pos, cfg: ModelConfig, mode: str = hgq.EVAL,
                    kv_bits: Optional[int] = None):
        """One decode step over tokens [B, S_new] at ``cache_pos`` (scalar
        or per-slot [B]).  Writes the rings and recurrent states in
        place; returns (logits [B, S_new, V], caches).  ``p["units"]``
        may be the stacked tree or its per-unit views."""
        S = tokens.shape[1]
        dev = tokens.device
        units, rem, _ = _layer_counts(cfg)
        cp = torch.as_tensor(cache_pos, device=dev)
        e, _ = HEmbedding.apply(p["embed"], q["embed"], tokens, mode=mode,
                                aux=None)
        positions = decode_positions(cp, S)
        quant = caches.kf is not None

        def rec(lp, lq, x, i):
            x, _, ns = GriffinLM._block(
                lp, lq, x, "rec", cfg, mode, None, positions,
                rec_state=GriffinState(caches.conv[i], caches.h[i]))
            caches.conv[i].copy_(ns.conv)
            caches.h[i].copy_(ns.h)
            return x

        x = e.q
        for u, (up, uq) in enumerate(zip(_units(p, cfg), _units(q, cfg))):
            x = rec(up["rec1"], uq["rec1"], x, 2 * u)
            x = rec(up["rec2"], uq["rec2"], x, 2 * u + 1)
            kvc = QKVCache(caches.k[u], caches.v[u], caches.kf[u],
                           caches.vf[u]) if quant \
                else KVCache(caches.k[u], caches.v[u])
            x, _, _ = GriffinLM._block(up["att"], uq["att"], x, "att", cfg,
                                       mode, None, positions, kv_cache=kvc,
                                       cache_pos=cp, kv_bits=kv_bits)
        for i in range(rem):
            x = rec(p["rem"][i], q["rem"][i], x, 2 * units + i)
        h, _ = RMSNorm.apply(p["final_norm"], q["final_norm"], x, mode=mode,
                             aux=None)
        lt, _ = HDense.apply(p["lm_head"], q["lm_head"], h, mode=mode,
                             aux=None)
        return lt.q, caches
