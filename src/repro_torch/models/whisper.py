"""Whisper-large-v3 backbone: an encoder-decoder transformer (counterpart
of ``repro/models/whisper.py``).

The conv / mel frontend is a stub, as in the reference: callers hand
over frame embeddings ``[B, T, d]`` (``enc_seq`` = 1500 frames at most).
Full MHA (``n_kv == n_heads``), LayerNorm and biases, a gelu MLP,
learned positions, the decoder's embedding tied to its head.

Params keep the reference's tree (``enc_layers`` and ``dec_layers``
stacked ``[L, ...]``, ``xattn`` the cross-attention), so plan keys
(``dec_layers/mlp/fc1/kernel``), ``from_jax`` and the packing walker
carry over unchanged; the reference's ``lax.scan`` over the stacked
layers becomes a loop over per-layer views, each layer rematerialized
in its backward with ``cfg.remat``, as ``TransformerLM`` loops.

Serving: the decoder runs the ragged decode path (``decode_step`` with
per-slot ``cache_pos``) and the encoder memory streams in:
``append_cross`` encodes one audio chunk block-locally at the cache's
absolute frame offset and appends its cross K/V rows at ``mem_len``.
The decode's cross read masks the memory by ``memory_tpos``, so a
partly streamed memory is read exactly and a row with ``mem_len == 0``
(LM traffic in the same batch) reads zero.  Under a quantized plan the
cross rows sit on the self ring's int8 2^-f grids and go through the same
kernels: one ``kv_quantize_store`` launch stores a chunk's rows for every
layer, ``kv_attention_rows`` reads them.

The TRAIN and EVAL forward return the cross K/V range states under
``dec_layers/xattn/{wk,wv}``, where the init qstate keeps them, so the
new qstate has the init qstate's leaf paths and a trained qstate takes
the next step or builds an engine.  The reference returns them under a
key of its own (``dec_layers/xattn_kv``) and drops them from ``xattn``:
the same values, another tree, which its second jitted step refuses.

Caches are written IN PLACE (the self ring by ``GQAAttention``, the cross
memory and ``mem_len`` by ``append_cross``); the caches object is
returned as given.  The head dequantizes the (packed) table and
multiplies by it with ``torch.matmul``, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core import hgq
from ..core.hgq import Aux, QTensor
from ..device import resolve_device
from ..kernels.kv_dequant.ops import kv_attention_decode, kv_quantize_store
from ..nn.attention import (AttnConfig, GQAAttention, KVCache, QKVCache,
                            _decode_attention, _quant_probs,
                            decode_positions, memory_tpos)
from ..nn.basic import HDense, HEmbedding, LayerNorm
from ..nn.common import get_qw
from ..nn.mlp import MLP
from ..tree import tree_map
from .config import ModelConfig
from .lm import layer_views

# rows of the decoder's learned position table (indexed modulo)
DEC_POS_ROWS = 4096


class WhisperCaches(NamedTuple):
    self_k: torch.Tensor    # [L, B, S_max, H, hd] (int8 mantissas quantized)
    self_v: torch.Tensor
    cross_k: torch.Tensor   # [L, B, enc_seq, H, hd] (int8 mantissas quantized)
    cross_v: torch.Tensor
    mem_len: torch.Tensor   # [1, B] int32: encoder frames written a slot
    self_kf: Optional[torch.Tensor] = None   # [L, B, S_max, H] exponents
    self_vf: Optional[torch.Tensor] = None   # (None: the fp self cache)
    cross_kf: Optional[torch.Tensor] = None  # [L, B, enc_seq, H] exponents
    cross_vf: Optional[torch.Tensor] = None  # (None: the fp cross memory)


def _attn_cfg(cfg: ModelConfig, causal: bool) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv=cfg.n_kv, head_dim=cfg.hd, qkv_bias=True,
                      causal=causal, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)


def _layers(tree, key: str, n: int):
    """``tree[key]`` as per-layer trees: itself where it is a list of views
    already (``serving_views``), else its views."""
    ls = tree[key]
    return ls if isinstance(ls, list) else layer_views(ls, n)


def decoder_positions(table: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """The decoder's learned position rows at ``positions`` (modulo the
    table's rows)."""
    return table[torch.remainder(positions.to(torch.int64), table.shape[0])]


def _stack(trees):
    return tree_map(lambda *a: torch.stack(a), *trees)


def _eval_biases(tree):
    """``tree`` with every dense bias ``{"w", "f"}`` replaced by ``{"w":
    its EVAL quantized value}``."""
    if isinstance(tree, list):
        return [_eval_biases(t) for t in tree]
    if not isinstance(tree, dict):
        return tree
    return {k: {"w": get_qw(v, hgq.EVAL).q}
            if k == "bias" and isinstance(v, dict) and "f" in v
            else _eval_biases(v) for k, v in tree.items()}


class CrossAttention:
    """q from the decoder stream, k / v from the encoder memory."""

    @staticmethod
    def init(gen, cfg: ModelConfig, device=None):
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
        p: Dict[str, Any] = {}
        q: Dict[str, Any] = {}
        p["wq"], q["wq"] = HDense.init(gen, d, H * hd, cfg.hgq, bias=True,
                                       device=device)
        p["wk"], q["wk"] = HDense.init(gen, d, H * hd, cfg.hgq, bias=False,
                                       device=device)
        p["wv"], q["wv"] = HDense.init(gen, d, H * hd, cfg.hgq, bias=True,
                                       device=device)
        p["wo"], q["wo"] = HDense.init(gen, H * hd, d, cfg.hgq, bias=True,
                                       out_q=False, device=device)
        if cfg.hgq.enabled:
            p["probs_f"] = torch.full((), cfg.hgq.init_act_f,
                                      dtype=torch.float32, device=device)
        return p, q

    @staticmethod
    def kv(p, q, memory: QTensor, cfg: ModelConfig, mode: str,
           aux: Optional[Aux]):
        """(k, v) ``[B, T, H, hd]`` of the memory and their new range
        states."""
        B, T, _ = memory.q.shape
        kt, nk = HDense.apply(p["wk"], q["wk"], memory, mode=mode, aux=aux)
        vt, nv = HDense.apply(p["wv"], q["wv"], memory, mode=mode, aux=aux)
        H, hd = cfg.n_heads, cfg.hd
        return (kt.q.reshape(B, T, H, hd), vt.q.reshape(B, T, H, hd),
                {"wk": nk, "wv": nv})

    @staticmethod
    def apply(p, q, x: QTensor, kh, vh, cfg: ModelConfig, mode: str,
              aux: Optional[Aux]):
        """The no-cache read: every query row over the whole memory, one
        softmax a row, in query chunks of ``q_chunk`` rows (the rows are
        independent, so the reference's padding of the last chunk changes
        no kept row)."""
        B, S, _ = x.q.shape
        H, hd = cfg.n_heads, cfg.hd
        newq: Dict[str, Any] = {}
        qt, newq["wq"] = HDense.apply(p["wq"], q["wq"], x, mode=mode, aux=aux)
        qh = qt.q.reshape(B, S, H, hd)
        scale = hd ** -0.5
        cq = min(cfg.q_chunk, S)
        probs_f = p.get("probs_f")
        outs = []
        for i in range(0, S, cq):
            s = torch.einsum("bqhd,bthd->bhqt", qh[:, i:i + cq], kh) * scale
            pt = _quant_probs(torch.softmax(s, dim=-1), probs_f, mode)
            outs.append(torch.einsum("bhqt,bthd->bqhd", pt, vh))
        o = torch.cat(outs, dim=1).reshape(B, S, H * hd).to(x.q.dtype)
        yo, newq["wo"] = HDense.apply(p["wo"], q["wo"], QTensor(o, None),
                                      mode=mode, aux=aux)
        if probs_f is not None and aux is not None:
            aux.add(l1=torch.relu(probs_f))
        return yo, newq

    @staticmethod
    def decode(p, q, x: QTensor, ck, cv, mem, cfg: ModelConfig, mode: str,
               aux: Optional[Aux], ckf=None, cvf=None, tpos=None):
        """The decode read over the (partly streamed, perhaps quantized)
        memory: only the ``mem[b]`` written rows are visible
        (``memory_tpos``; ``tpos`` [B, T] may be given made), every one to
        every query row, and a row with ``mem == 0`` reads exactly zero.
        ``ckf`` / ``cvf`` select the fused dequant-attention kernel over
        the int8 2^-f mantissas."""
        B, S, _ = x.q.shape
        H, hd = cfg.n_heads, cfg.hd
        newq: Dict[str, Any] = {}
        qt, newq["wq"] = HDense.apply(p["wq"], q["wq"], x, mode=mode, aux=aux)
        qh = qt.q.reshape(B, S, H, hd)
        T = ck.shape[1]
        if tpos is None:
            tpos = memory_tpos(mem, T)
        qpos = torch.full((B, S), T, dtype=torch.int32, device=qh.device)
        probs_f = p.get("probs_f")
        if ckf is not None:
            out = kv_attention_decode(qh, ck, ckf, cv, cvf, qpos, tpos,
                                      window=None, n_kv=H, probs_f=probs_f)
        else:
            acfg = dataclasses.replace(_attn_cfg(cfg, causal=False), n_kv=H)
            out = _decode_attention(qh, ck.to(torch.float32),
                                    cv.to(torch.float32), qpos, acfg,
                                    probs_f, mode, tpos=tpos)
        o = out.reshape(B, S, H * hd).to(x.q.dtype)
        yo, newq["wo"] = HDense.apply(p["wo"], q["wo"], QTensor(o, None),
                                      mode=mode, aux=aux)
        if probs_f is not None and aux is not None:
            aux.add(l1=torch.relu(probs_f))
        return yo, newq


class WhisperModel:
    """Static ``init`` / ``encode`` / ``forward`` / ``init_cache`` /
    ``append_cross`` / ``decode_step`` over explicit trees, as the other
    models'."""

    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig, device=None):
        """Seeded init with the reference's distributions (its numbers
        differ: ``torch.Generator`` is not ``jax.random``)."""
        dev = resolve_device(device)
        d = cfg.d_model
        p: Dict[str, Any] = {}
        q: Dict[str, Any] = {}
        # encoder (frame embeddings come made: the frontend is a stub)
        p["enc_pos"] = 0.02 * torch.randn((cfg.enc_seq, d), generator=gen,
                                          device=dev)
        per = []
        for _ in range(cfg.enc_layers):
            lp: Dict[str, Any] = {}
            lq: Dict[str, Any] = {}
            lp["ln1"], lq["ln1"] = LayerNorm.init(gen, d, cfg.hgq, device=dev)
            lp["attn"], lq["attn"] = GQAAttention.init(
                gen, _attn_cfg(cfg, causal=False), cfg.hgq, dev)
            lp["ln2"], lq["ln2"] = LayerNorm.init(gen, d, cfg.hgq, device=dev)
            lp["mlp"], lq["mlp"] = MLP.init(gen, d, cfg.d_ff, cfg.hgq,
                                            device=dev)
            per.append((lp, lq))
        p["enc_layers"] = _stack([a for a, _ in per])
        q["enc_layers"] = _stack([b for _, b in per])
        p["enc_norm"], q["enc_norm"] = LayerNorm.init(gen, d, cfg.hgq,
                                                      device=dev)
        # decoder
        p["embed"], q["embed"] = HEmbedding.init(gen, cfg.vocab, d, cfg.hgq,
                                                 dev)
        p["dec_pos"] = 0.02 * torch.randn((DEC_POS_ROWS, d), generator=gen,
                                          device=dev)
        per = []
        for _ in range(cfg.n_layers):
            lp = {}
            lq = {}
            lp["ln1"], lq["ln1"] = LayerNorm.init(gen, d, cfg.hgq, device=dev)
            lp["attn"], lq["attn"] = GQAAttention.init(
                gen, _attn_cfg(cfg, causal=True), cfg.hgq, dev)
            lp["ln_x"], lq["ln_x"] = LayerNorm.init(gen, d, cfg.hgq,
                                                    device=dev)
            lp["xattn"], lq["xattn"] = CrossAttention.init(gen, cfg, dev)
            lp["ln2"], lq["ln2"] = LayerNorm.init(gen, d, cfg.hgq, device=dev)
            lp["mlp"], lq["mlp"] = MLP.init(gen, d, cfg.d_ff, cfg.hgq,
                                            device=dev)
            per.append((lp, lq))
        p["dec_layers"] = _stack([a for a, _ in per])
        q["dec_layers"] = _stack([b for _, b in per])
        p["dec_norm"], q["dec_norm"] = LayerNorm.init(gen, d, cfg.hgq,
                                                      device=dev)
        return p, q

    @staticmethod
    def serving_views(tree, cfg: ModelConfig):
        """A params or qstate tree for EVAL serving, made once (the engine's
        tick loops over it): both stacks of layers as per-layer views, and
        every dense bias ``{"w", "f"}`` quantized once to its EVAL value
        (``get_qw``) and kept without ``f``, so a tick adds the same bias
        values without quantizing them (and estimating their bits, which
        no decode step reads) again in every layer."""
        views = {**tree,
                 "enc_layers": _layers(tree, "enc_layers", cfg.enc_layers),
                 "dec_layers": _layers(tree, "dec_layers", cfg.n_layers)}
        return _eval_biases(views)

    # ------------------------------ encoder -----------------------------
    @staticmethod
    def _enc_layer(lp, lq, h, positions, cfg: ModelConfig, mode: str,
                   with_aux: bool):
        a = Aux.zero(h.device) if with_aux else None
        nq: Dict[str, Any] = {}
        n1, nq["ln1"] = LayerNorm.apply(lp["ln1"], lq["ln1"], h, mode=mode,
                                        aux=a)
        at, nq["attn"], _ = GQAAttention.apply(
            lp["attn"], lq["attn"], n1, cfg=_attn_cfg(cfg, causal=False),
            mode=mode, aux=a, positions=positions)
        h = h + at.q
        n2, nq["ln2"] = LayerNorm.apply(lp["ln2"], lq["ln2"], h, mode=mode,
                                        aux=a)
        mt, nq["mlp"] = MLP.apply(lp["mlp"], lq["mlp"], n2, mode=mode, aux=a)
        return h + mt.q, nq, None if a is None else a.as_tuple()

    @staticmethod
    def encode(p, q, frame_embeds: torch.Tensor, cfg: ModelConfig,
               mode: str, aux: Optional[Aux], offset=0):
        """Encode a block of frames at absolute frame position ``offset``
        (an int, or a 0-d tensor that stays on the device): the learned
        positions are taken there and the RoPE phases start there, so a
        streamed block and the same block of a whole-audio pass agree.
        ``aux=None`` skips the ~EBOPs / L1 bookkeeping and the stacking of
        the new range states (returned as None)."""
        T = frame_embeds.shape[1]
        dev = frame_embeds.device
        if isinstance(offset, int):
            pe = p["enc_pos"][offset:offset + T]
            positions = offset + torch.arange(T, device=dev)
        else:
            positions = offset.to(torch.int64) + torch.arange(T, device=dev)
            pe = p["enc_pos"].index_select(0, positions)
        x = frame_embeds + pe[None]
        with_aux = aux is not None
        eb = torch.zeros((), dtype=torch.float32, device=dev)
        l1 = torch.zeros((), dtype=torch.float32, device=dev)
        newqs = []
        for lp, lq in zip(_layers(p, "enc_layers", cfg.enc_layers),
                          _layers(q, "enc_layers", cfg.enc_layers)):
            args = (lp, lq, x, positions, cfg, mode, with_aux)
            if cfg.remat and torch.is_grad_enabled():
                h, nq, e = checkpoint(WhisperModel._enc_layer, *args,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                h, nq, e = WhisperModel._enc_layer(*args)
            x = h.to(x.dtype)
            if with_aux:
                eb, l1 = eb + e[0], l1 + e[1]
                newqs.append(nq)
        if with_aux:
            aux.add(ebops=eb, l1=l1)
        n, nq_n = LayerNorm.apply(p["enc_norm"], q["enc_norm"], x, mode=mode,
                                  aux=aux)
        return n, ({"enc_layers": _stack(newqs), "enc_norm": nq_n}
                   if with_aux else None)

    # ------------------------------ decoder -----------------------------
    @staticmethod
    def _dec_layer(lp, lq, h, positions, cfg: ModelConfig, mode: str,
                   with_aux: bool, memory: Optional[QTensor] = None,
                   kvc=None, cache_pos=None, kv_bits: Optional[int] = None,
                   cross=None):
        """One decoder layer over ``memory`` (no cache: forward) or, with
        ``cross`` = (ck, cv, ckf, cvf, tpos) a layer's memory cache, the
        decode step writing the self ring ``kvc`` at ``cache_pos``."""
        a = Aux.zero(h.device) if with_aux else None
        nq: Dict[str, Any] = {}
        n1, nq["ln1"] = LayerNorm.apply(lp["ln1"], lq["ln1"], h, mode=mode,
                                        aux=a)
        at, nq["attn"], _ = GQAAttention.apply(
            lp["attn"], lq["attn"], n1, cfg=_attn_cfg(cfg, causal=True),
            mode=mode, aux=a, positions=positions, cache=kvc,
            cache_pos=cache_pos, kv_bits=kv_bits)
        h = h + at.q
        nx, nq["ln_x"] = LayerNorm.apply(lp["ln_x"], lq["ln_x"], h,
                                         mode=mode, aux=a)
        if cross is not None:
            ck, cv, ckf, cvf, tpos = cross
            # the stored memory's K/V range states stay as they were
            kv_states = {k: lq["xattn"][k] for k in ("wk", "wv")
                         if k in lq["xattn"]}
            xt, nq["xattn"] = CrossAttention.decode(
                lp["xattn"], lq["xattn"], nx, ck, cv, None, cfg, mode, a,
                ckf=ckf, cvf=cvf, tpos=tpos)
        else:
            kh, vh, kv_states = CrossAttention.kv(
                lp["xattn"], lq["xattn"], memory, cfg, mode, a)
            xt, nq["xattn"] = CrossAttention.apply(
                lp["xattn"], lq["xattn"], nx, kh, vh, cfg, mode, a)
        # the cross K/V range states go back where the init qstate keeps
        # them (``xattn/{wk,wv}``), so a trained qstate has the init
        # qstate's leaf paths and takes a second step
        nq["xattn"].update(kv_states)
        h = h + xt.q
        n2, nq["ln2"] = LayerNorm.apply(lp["ln2"], lq["ln2"], h, mode=mode,
                                        aux=a)
        mt, nq["mlp"] = MLP.apply(lp["mlp"], lq["mlp"], n2, mode=mode, aux=a)
        return h + mt.q, nq, None if a is None else a.as_tuple()

    @staticmethod
    def _logits(p, h: QTensor, cfg: ModelConfig, mode: str,
                aux: Optional[Aux]) -> torch.Tensor:
        """The tied head as the reference computes it: the table
        quantized (a packed one dequantized), then a plain matmul."""
        wq = get_qw(p["embed"]["table"], mode)
        logits = torch.matmul(h.q.to(wq.q.dtype), wq.q.T)
        hgq.matmul_ebops(aux, h.bits, None if wq.bits is None else wq.bits.T,
                         cfg.d_model, cfg.vocab)
        return logits

    # ------------------------------ forward -----------------------------
    @staticmethod
    def forward(p, q, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                mode: str = hgq.TRAIN):
        """batch: ``frame_embeds`` [B, enc_seq, d], ``tokens`` [B, S]:
        (logits [B, S, V], new qstate, Aux)."""
        frames = batch["frame_embeds"]
        aux = Aux.zero(frames.device)
        newq: Dict[str, Any] = {}
        mem, nq_enc = WhisperModel.encode(p, q, frames, cfg, mode, aux)
        newq.update(nq_enc)
        tokens = batch["tokens"]
        S = tokens.shape[1]
        e, newq["embed"] = HEmbedding.apply(p["embed"], q["embed"], tokens,
                                            mode=mode, aux=aux)
        positions = torch.arange(S, device=tokens.device)
        x = e.q + decoder_positions(p["dec_pos"], positions)[None]
        eb = torch.zeros((), dtype=torch.float32, device=x.device)
        l1 = torch.zeros((), dtype=torch.float32, device=x.device)
        newqs = []
        for lp, lq in zip(_layers(p, "dec_layers", cfg.n_layers),
                          _layers(q, "dec_layers", cfg.n_layers)):
            args = (lp, lq, x, positions, cfg, mode, True, mem)
            if cfg.remat and torch.is_grad_enabled():
                h, nq, (a, b) = checkpoint(WhisperModel._dec_layer, *args,
                                           use_reentrant=False,
                                           preserve_rng_state=False)
            else:
                h, nq, (a, b) = WhisperModel._dec_layer(*args)
            x = h.to(x.dtype)
            eb, l1 = eb + a, l1 + b
            newqs.append(nq)
        aux.add(ebops=eb, l1=l1)
        newq["dec_layers"] = _stack(newqs)
        h, newq["dec_norm"] = LayerNorm.apply(p["dec_norm"], q["dec_norm"], x,
                                              mode=mode, aux=aux)
        return WhisperModel._logits(p, h, cfg, mode, aux), newq, aux

    # ------------------------------ serving -----------------------------
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, ring_slack: int = 0,
                   kv_bits: Optional[int] = None,
                   device=None) -> WhisperCaches:
        """Zeroed self ring ``[L, B, max_len, H, hd]`` and cross memory
        ``[L, B, enc_seq, H, hd]``, on the quantized grids with
        ``kv_bits`` (``serving/kvcache.py``); ``ring_slack`` is taken for
        the engine's sake (the self ring is not windowed)."""
        del ring_slack
        dev = resolve_device(device)
        L, H, hd = cfg.n_layers, cfg.n_heads, cfg.hd
        self_shape = (L, batch, max_len, H, hd)
        cross_shape = (L, batch, cfg.enc_seq, H, hd)
        if kv_bits is not None:
            from ..serving.kvcache import quantized_cache
            qs = quantized_cache(self_shape, kv_bits, device=dev)
            qx = quantized_cache(cross_shape, kv_bits, device=dev)
            fields = dict(self_k=qs.k, self_v=qs.v, self_kf=qs.kf,
                          self_vf=qs.vf, cross_k=qx.k, cross_v=qx.v,
                          cross_kf=qx.kf, cross_vf=qx.vf)
        else:
            def z(shape):
                return torch.zeros(shape, dtype=dtype, device=dev)
            fields = dict(self_k=z(self_shape), self_v=z(self_shape),
                          cross_k=z(cross_shape), cross_v=z(cross_shape))
        return WhisperCaches(
            mem_len=torch.zeros((1, batch), dtype=torch.int32, device=dev),
            **fields)

    @staticmethod
    def append_cross(p, q, caches: WhisperCaches, frame_chunk: torch.Tensor,
                     cfg: ModelConfig, mode: str = hgq.EVAL,
                     kv_bits: Optional[int] = None) -> WhisperCaches:
        """Encode one audio chunk ``[B, T, d]`` block-locally at the
        cache's memory offset (``mem_len``, read on the device) and
        append its cross K/V rows there for every decoder layer, in place;
        ``mem_len`` advances by T for every row (the engine appends on
        single-slot slices).  A quantized memory takes the rows of all
        layers in one ``kv_quantize_store`` launch, through ``[L * B,
        enc_seq, H, hdm]`` views of the cache (the reference's quantize,
        pack and write at the offset)."""
        off = caches.mem_len[0, 0]
        mem, _ = WhisperModel.encode(p, q, frame_chunk, cfg, mode, None,
                                     offset=off)
        ks, vs = [], []
        for lp, lq in zip(_layers(p, "dec_layers", cfg.n_layers),
                          _layers(q, "dec_layers", cfg.n_layers)):
            kh, vh, _ = CrossAttention.kv(lp["xattn"], lq["xattn"], mem, cfg,
                                          mode, None)
            ks.append(kh)
            vs.append(vh)
        K, V = torch.stack(ks), torch.stack(vs)          # [L, B, T, H, hd]
        L, B, T, H, hd = K.shape
        slot = off.to(torch.int64) + torch.arange(T, device=K.device)
        if caches.cross_kf is not None:
            def rows(c):
                return c.view((L * B,) + tuple(c.shape[2:]))
            kv_quantize_store(rows(K), rows(V), slot.expand(L * B, T),
                              rows(caches.cross_k), rows(caches.cross_v),
                              rows(caches.cross_kf), rows(caches.cross_vf),
                              kv_bits or 8)
        else:
            caches.cross_k.index_copy_(2, slot, K.to(caches.cross_k.dtype))
            caches.cross_v.index_copy_(2, slot, V.to(caches.cross_v.dtype))
        caches.mem_len.add_(T)
        return caches

    @staticmethod
    def prefill_cross(p, q, caches: WhisperCaches, frame_embeds, cfg,
                      mode: str = hgq.EVAL,
                      kv_bits: Optional[int] = None) -> WhisperCaches:
        """Whole-audio memory prefill: one ``append_cross`` covering the
        audio on a fresh cache (the offline encoder)."""
        return WhisperModel.append_cross(p, q, caches, frame_embeds, cfg,
                                         mode=mode, kv_bits=kv_bits)

    @staticmethod
    def decode_step(p, q, caches: WhisperCaches, tokens: torch.Tensor,
                    cache_pos, cfg: ModelConfig, mode: str = hgq.EVAL,
                    kv_bits: Optional[int] = None):
        """One decode step over tokens [B, S_new] at ``cache_pos`` (scalar
        or per-slot [B]): the self ring written in place, the cross memory
        read up to each row's ``mem_len``.  Returns (logits [B, S_new, V],
        caches).  ``p``'s layer stacks may be stacked or per-layer views."""
        S = tokens.shape[1]
        cp = torch.as_tensor(cache_pos, device=tokens.device)
        e, _ = HEmbedding.apply(p["embed"], q["embed"], tokens, mode=mode,
                                aux=None)
        positions = decode_positions(cp, S)
        pe = decoder_positions(p["dec_pos"], positions)
        x = e.q + (pe if positions.ndim == 2 else pe[None])
        # the memory's slot positions, the same for every layer
        tpos = memory_tpos(caches.mem_len[0], caches.cross_k.shape[2])
        quant = caches.self_kf is not None
        cross_q = caches.cross_kf is not None
        for l, (lp, lq) in enumerate(zip(
                _layers(p, "dec_layers", cfg.n_layers),
                _layers(q, "dec_layers", cfg.n_layers))):
            kvc = QKVCache(caches.self_k[l], caches.self_v[l],
                           caches.self_kf[l], caches.self_vf[l]) if quant \
                else KVCache(caches.self_k[l], caches.self_v[l])
            cross = (caches.cross_k[l], caches.cross_v[l],
                     caches.cross_kf[l] if cross_q else None,
                     caches.cross_vf[l] if cross_q else None, tpos)
            x, _, _ = WhisperModel._dec_layer(
                lp, lq, x, positions, cfg, mode, False, kvc=kvc,
                cache_pos=cp, kv_bits=kv_bits, cross=cross)
        h, _ = LayerNorm.apply(p["dec_norm"], q["dec_norm"], x, mode=mode,
                               aux=None)
        return WhisperModel._logits(p, h, cfg, mode, None), caches
