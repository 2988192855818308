"""Decoder-only transformer LM, dense / MoE / VLM-backbone families
(counterpart of ``repro/models/lm.py``): the training / prefill
``forward`` and the decode path.

Params keep the JAX tree: nested dicts with stacked ``[L, ...]`` layer
leaves, so plan keys (``layers/mlp/gate/kernel``), ``from_jax`` and the
checkpoints carry over unchanged.  ``lax.scan`` over layers becomes a
Python loop over per-layer views; the training forward unbinds the
stacked leaves (one gradient stack a leaf), remats each layer with
``torch.utils.checkpoint`` when ``cfg.remat``, sums the layers' ~EBOPs
and L1 as the scan's carry does and stacks their new range states back
to ``[L, ...]``.  In TRAIN a layer's projection weight and bias
quantizers, an MoE block's router and expert stacks among them, run as
one group (one ``hgq_quantize`` forward launch on the card).  The
residual stream stays unquantized; activation quantizers sit at the norm
and projection outputs.
"""
from __future__ import annotations

import types
from typing import Any, Dict, List, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import hgq
from ..core.hgq import Aux, QTensor
from ..device import resolve_device
from ..dist.perf import (cast_for_matmul, get_packed_matmul, is_packed,
                         packed_mantissas)
from ..kernels.qmatmul.ops import qmatmul_any
from ..nn.attention import (AttnConfig, GQAAttention, KVCache, QKVCache,
                            decode_positions)
from ..nn.basic import HDense, HEmbedding, LayerNorm, RMSNorm
from ..nn.common import get_qw, quantize_weights
from ..nn.mlp import GLUMLP
from ..nn.moe import MoE, MoEConfig
from ..tree import tree_leaves, tree_map, tree_unflatten
from .config import ModelConfig

Caches = Union[KVCache, QKVCache]


def _norm_cls(cfg: ModelConfig):
    return RMSNorm if cfg.norm == "rms" else LayerNorm


def _attn_cfg(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv=cfg.n_kv, head_dim=cfg.hd, qkv_bias=cfg.qkv_bias,
                      rope_theta=cfg.rope_theta, window=cfg.window,
                      causal=True, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)


def _moe_cfg(cfg: ModelConfig) -> MoEConfig:
    return MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                     n_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                     act=cfg.act)


def layer_views(stacked: Any, n_layers: int) -> List[Any]:
    """Stacked ``[L, ...]`` layer tree -> one tree of views per layer, by
    ``unbind``: under autograd each stacked leaf gets one backward that
    stacks its layers' gradients, where an index a layer would add a
    zero-filled ``[L, ...]`` gradient each."""
    per_leaf = [a.unbind(0) for a in tree_leaves(stacked)]
    return [tree_unflatten(stacked, [u[i] for u in per_leaf])
            for i in range(n_layers)]


# a layer's projections, whose weights and biases one grouped quantizer
# launch makes in TRAIN: a dense projection's kernel and bias, an MoE
# block's router kernel and its three expert stacks (stored weights
# themselves, ``{"w", "f"}``)
_PROJECTIONS = types.MappingProxyType({
    "attn": ("wq", "wk", "wv", "wo"), "mlp": ("gate", "up", "down"),
    "moe": ("router", "gate", "up", "down")})


def _layer_weights(lp, mode: str) -> Dict[str, Any]:
    """{block: {projection: its quantized kernel and bias, or an expert
    stack's QTensor}} for the layer's blocks of ``_PROJECTIONS``, made in
    one group in TRAIN (10 members for qwen2: q, k, v with biases, o,
    gate, up, down; 8 for granite: q, k, v, o, the router, the gate, up
    and down stacks); {block: None} (each projection quantizes its own)
    otherwise."""
    blocks = {b: names for b, names in _PROJECTIONS.items() if b in lp}
    if mode != hgq.TRAIN:
        return {blk: None for blk in blocks}
    keys = []
    for blk, names in blocks.items():
        for name in names:
            node = lp[blk][name]
            if "w" in node:                     # an expert stack
                keys.append((blk, name, None))
            else:
                keys.extend((blk, name, k) for k in ("kernel", "bias")
                            if k in node)
    qs = quantize_weights([lp[b][n] if k is None else lp[b][n][k]
                           for b, n, k in keys], mode)
    out: Dict[str, Any] = {blk: {n: {} for n in names}
                           for blk, names in blocks.items()}
    for (b, n, k), t in zip(keys, qs):
        if k is None:
            out[b][n] = t
        else:
            out[b][n][k] = t
    return out


def _check_positions(cache_pos, S: int, W: int) -> None:
    """An unwindowed cache holds positions 0..W-1: reject a chunk that
    would write past it (checked only where the positions live on the
    host, so no decode tick waits for the device)."""
    if isinstance(cache_pos, torch.Tensor) and cache_pos.is_cuda:
        return
    top = int(torch.as_tensor(cache_pos).max()) + S
    if top > W:
        raise ValueError(f"positions up to {top - 1} do not fit the "
                         f"{W}-slot cache")


class TransformerLM(nn.Module):
    """Holds one params / qstate tree (buffers, for ``.to()`` and
    ``state_dict``); the static ``init`` / ``forward`` / ``init_cache`` /
    ``decode_step`` take trees explicitly, as the engine serves a packed
    copy of the tree and ``make_train_step`` trains one."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 qstate: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.cfg = cfg
        self.params = params
        self.qstate = qstate if qstate is not None else {}
        for prefix, tree in (("p", self.params), ("q", self.qstate)):
            for path, leaf in _flatten(tree):
                self.register_buffer("__".join((prefix,) + path), leaf,
                                     persistent=True)

    def __call__(self, tokens: torch.Tensor, caches: Caches, cache_pos,
                 kv_bits: Optional[int] = None):
        """Calling the module decodes over its own trees; ``forward`` is
        the reference's static training / prefill forward."""
        return self.decode_step(self.params, self.qstate, caches, tokens,
                                cache_pos, self.cfg, kv_bits=kv_bits)

    # ---------------------------- init ----------------------------------
    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig, device=None):
        """Seeded init with the reference's distributions (its numbers
        differ: ``torch.Generator`` is not ``jax.random``)."""
        dev = resolve_device(device)
        Norm = _norm_cls(cfg)
        p: Dict[str, Any] = {}
        q: Dict[str, Any] = {}
        p["embed"], q["embed"] = HEmbedding.init(gen, cfg.vocab, cfg.d_model,
                                                 cfg.hgq, dev)
        per_p, per_q = [], []
        for _ in range(cfg.n_layers):
            lp: Dict[str, Any] = {}
            lq: Dict[str, Any] = {}
            lp["ln1"], lq["ln1"] = Norm.init(gen, cfg.d_model, cfg.hgq,
                                             device=dev)
            lp["attn"], lq["attn"] = GQAAttention.init(gen, _attn_cfg(cfg),
                                                       cfg.hgq, dev)
            lp["ln2"], lq["ln2"] = Norm.init(gen, cfg.d_model, cfg.hgq,
                                             device=dev)
            if cfg.moe_experts:
                lp["moe"], lq["moe"] = MoE.init(gen, _moe_cfg(cfg), cfg.hgq,
                                                dev)
            else:
                lp["mlp"], lq["mlp"] = GLUMLP.init(gen, cfg.d_model,
                                                   cfg.d_ff, cfg.hgq, dev)
            per_p.append(lp)
            per_q.append(lq)
        p["layers"] = tree_map(lambda *a: torch.stack(a), *per_p)
        q["layers"] = tree_map(lambda *a: torch.stack(a), *per_q)
        p["final_norm"], q["final_norm"] = Norm.init(gen, cfg.d_model,
                                                     cfg.hgq, device=dev)
        if not cfg.tie_embeddings:
            p["lm_head"], q["lm_head"] = HDense.init(
                gen, cfg.d_model, cfg.vocab, cfg.hgq, bias=False,
                out_q=False, device=dev)
        return p, q

    # -------------------------- layer body ------------------------------
    @staticmethod
    def _layer(lp, lq, x, positions, cache, cache_pos, cfg: ModelConfig,
               mode: str, kv_bits: Optional[int] = None, with_aux=True):
        """One layer: (x, new range states, (~EBOPs, L1) or None without
        ``with_aux``, a decode step whose Aux nobody reads)."""
        Norm = _norm_cls(cfg)
        aux = Aux.zero(x.device) if with_aux else None
        w = _layer_weights(lp, mode)
        newq: Dict[str, Any] = {}
        h, newq["ln1"] = Norm.apply(lp["ln1"], lq["ln1"], x, mode=mode,
                                    aux=aux)
        a, newq["attn"], _ = GQAAttention.apply(
            lp["attn"], lq["attn"], h, cfg=_attn_cfg(cfg), mode=mode,
            aux=aux, positions=positions, cache=cache, cache_pos=cache_pos,
            kv_bits=kv_bits, weights=w["attn"])
        x = x + a.q
        h, newq["ln2"] = Norm.apply(lp["ln2"], lq["ln2"], x, mode=mode,
                                    aux=aux)
        if cfg.moe_experts:
            m, newq["moe"] = MoE.apply(lp["moe"], lq["moe"], h,
                                       cfg=_moe_cfg(cfg), mode=mode, aux=aux,
                                       weights=w["moe"])
        else:
            m, newq["mlp"] = GLUMLP.apply(lp["mlp"], lq["mlp"], h, mode=mode,
                                          aux=aux, act=cfg.act,
                                          weights=w["mlp"])
        return x + m.q, newq, None if aux is None else aux.as_tuple()

    # -------------------------- layer loop ------------------------------
    @staticmethod
    def _stack_forward(p, q, x, positions, cfg: ModelConfig, mode: str):
        """The no-cache layer loop: (x, new layer range states stacked to
        ``[L, ...]``, (~EBOPs, L1) summed over the layers).  With
        ``cfg.remat`` (and autograd on) each layer is recomputed in its
        backward; the recompute's range states are discarded, the first
        pass's kept."""
        L = cfg.n_layers
        lps = layer_views(p["layers"], L)
        lqs = layer_views(q["layers"], L)
        ebops = torch.zeros((), dtype=torch.float32, device=x.device)
        l1 = torch.zeros((), dtype=torch.float32, device=x.device)
        newlqs = []
        for lp, lq in zip(lps, lqs):
            args = (lp, lq, x, positions, None, None, cfg, mode)
            if cfg.remat and torch.is_grad_enabled():
                h, newlq, (e, a) = checkpoint(TransformerLM._layer, *args,
                                              use_reentrant=False,
                                              preserve_rng_state=False)
            else:
                h, newlq, (e, a) = TransformerLM._layer(*args)
            x = h.to(x.dtype)
            ebops, l1 = ebops + e, l1 + a
            newlqs.append(newlq)
        return x, tree_map(lambda *a: torch.stack(a), *newlqs), (ebops, l1)

    # --------------------------- forward --------------------------------
    @staticmethod
    def forward(p, q, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                mode: str = hgq.TRAIN):
        """Training / prefill forward over ``batch["tokens"]`` [B, S]
        (positions 0..S-1, no cache), a VLM's ``batch["patch_embeds"]``
        [B, P, d] written over the first P positions: (logits [B, S, V],
        new qstate, Aux)."""
        tokens = batch["tokens"]
        S = tokens.shape[1]
        aux = Aux.zero(tokens.device)
        newq: Dict[str, Any] = {}
        e, newq["embed"] = HEmbedding.apply(p["embed"], q["embed"], tokens,
                                            mode=mode, aux=aux)
        x = cast_for_matmul(e.q)
        if cfg.n_patches and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        positions = torch.arange(S, device=tokens.device)
        x, newq["layers"], (ebops, l1) = TransformerLM._stack_forward(
            p, q, x, positions, cfg, mode)
        aux.add(ebops=ebops, l1=l1)
        Norm = _norm_cls(cfg)
        h, newq["final_norm"] = Norm.apply(p["final_norm"], q["final_norm"],
                                           x, mode=mode, aux=aux)
        logits = TransformerLM._logits(p, q, newq, h, cfg, mode, aux)
        return logits, newq, aux

    @staticmethod
    def _logits(p, q, newq, h: QTensor, cfg: ModelConfig, mode: str,
                aux: Optional[Aux]) -> torch.Tensor:
        if not cfg.tie_embeddings:
            lt, newq["lm_head"] = HDense.apply(p["lm_head"],
                                               q.get("lm_head", {}), h,
                                               mode=mode, aux=aux)
            return lt.q
        tbl = p["embed"]["table"]
        if is_packed(tbl) and get_packed_matmul():
            # tied head over the packed table: the per-embedding-column
            # scales fold into the activation, h @ (m * s).T ==
            # (h * s) @ m.T, and the kernel reads m.T without a copy.
            # A nibble table is packed along the vocab (the head's N),
            # which the kernel does not read: it is unpacked first.
            s_d = tbl["scale"].reshape(cfg.d_model)
            ones = torch.ones((cfg.vocab,), dtype=torch.float32,
                              device=h.q.device)
            m = tbl["w_int8"] if "w_int8" in tbl else packed_mantissas(tbl)
            return qmatmul_any(h.q.to(torch.float32) * s_d, m.T, ones)
        # the table quantized again (or, packed with the routing off,
        # dequantized), as the reference does
        wq = get_qw(tbl, mode)
        logits = torch.matmul(h.q.to(wq.q.dtype), wq.q.T)
        hgq.matmul_ebops(aux, h.bits, None if wq.bits is None else wq.bits.T,
                         cfg.d_model, cfg.vocab)
        return logits

    # ---------------------------- decode --------------------------------
    @staticmethod
    def serving_views(tree, cfg: ModelConfig):
        """A params or qstate tree with its stacked layers as per-layer
        views, made once (the engine's tick loops over them)."""
        return {**tree, "layers": layer_views(tree["layers"], cfg.n_layers)}

    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, ring_slack: int = 0,
                   kv_bits: Optional[int] = None, device=None) -> Caches:
        """Zeroed ``[L, B, W, KV, hd]`` cache stack; ``kv_bits`` selects the
        plan-width quantized storage (``serving/kvcache.py``)."""
        dev = resolve_device(device)
        kv_len = min(max_len, cfg.window + ring_slack) if cfg.window \
            else max_len
        shape = (cfg.n_layers, batch, kv_len, cfg.n_kv, cfg.hd)
        if kv_bits is not None:
            from ..serving.kvcache import quantized_cache
            return quantized_cache(shape, kv_bits, device=dev)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                       v=torch.zeros(shape, dtype=dtype, device=dev))

    @staticmethod
    def decode_step(p, q, caches: Caches, tokens: torch.Tensor, cache_pos,
                    cfg: ModelConfig, mode: str = hgq.EVAL,
                    kv_bits: Optional[int] = None):
        """One decode step over tokens [B, S_new] at ``cache_pos`` (scalar
        or per-slot [B]).  Writes the new rows into ``caches`` in place;
        returns (logits [B, S_new, V], caches).  ``p["layers"]`` may be
        the stacked tree or its :func:`layer_views` list."""
        B, S = tokens.shape
        dev = tokens.device
        W = caches.k.shape[2]
        if cfg.window is None:
            _check_positions(cache_pos, S, W)
        cp = torch.as_tensor(cache_pos, device=dev)
        L = cfg.n_layers
        lps = p["layers"] if isinstance(p["layers"], list) \
            else layer_views(p["layers"], L)
        lqs = q["layers"] if isinstance(q["layers"], list) \
            else layer_views(q["layers"], L)
        e, _ = HEmbedding.apply(p["embed"], q["embed"], tokens, mode=mode,
                                aux=None)
        positions = decode_positions(cp, S)
        x = e.q
        for l in range(L):
            cache_l = type(caches)(*(c[l] for c in caches))
            x, _, _ = TransformerLM._layer(lps[l], lqs[l], x, positions,
                                           cache_l, cp, cfg, mode, kv_bits,
                                           with_aux=False)
        Norm = _norm_cls(cfg)
        h, _ = Norm.apply(p["final_norm"], q["final_norm"], x, mode=mode,
                          aux=None)
        return TransformerLM._logits(p, q, {}, h, cfg, mode, None), caches


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree
