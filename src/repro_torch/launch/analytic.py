"""Analytic HBM-traffic model per (arch x shape x mesh) cell
(counterpart of ``repro/launch/analytic.py``: the same arithmetic on the
port's ``configs``, float for float).

A count of the bytes every operation reads and writes is not HBM
traffic: it counts values a fused kernel keeps on chip, and a remat
recompute twice.  For the roofline memory term we model the real traffic:

TRAIN (fp32 master, FSDP(dp) x TP(tp), full remat):
  weights   : gathered TP shard read 3x (fwd, remat-fwd, bwd)    3*4N/tp
  grads     : reduce-scattered shard written once                 4N/(dp*tp)
  optimizer : adam m,v read+write, params read+write         5*4N/(dp*tp)
  activations: remat saves layer inputs (write+read)       2*L*Bl*S*d*4
               + per-layer working set streamed               ~c_act*L*Bl*S*(d+ff')*4

PREFILL (bf16, TP):  weights once 2N/tp + activation stream
DECODE  (bf16, TP):  weights once per token 2N/tp + KV-cache shard read
                     (the canonical HBM-bound regime)

N is *active* params (MoE: top-k experts; the packed-bits serving path
scales the weight term by mean_bits/16: the HGQ packed-serving win).
``chips`` and ``tp`` describe an even partition of the global work; on
one card (``chips=1``, ``tp=1``) every term is the whole model's.
"""
from __future__ import annotations

from typing import Dict

from ..configs.base import ShapeSpec
from ..models.config import ModelConfig


def hbm_bytes_per_chip(cfg: ModelConfig, shape: ShapeSpec, chips: int,
                       tp: int = 16, *, weight_bits: float = 16.0,
                       cache_bytes: float = 2.0,
                       fsdp_gather: int = 3) -> Dict[str, float]:
    N = cfg.n_active_params()
    dp = max(chips // tp, 1)
    B = shape.global_batch
    Bl = max(B // dp, 1)
    S = shape.seq_len
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    out: Dict[str, float] = {}
    if shape.kind == "train":
        wb = 4.0  # fp32 master
        out["weights"] = fsdp_gather * wb * N / tp
        out["grads"] = wb * N / (dp * tp)
        out["optimizer"] = 5.0 * wb * N / (dp * tp)
        act_ff = ff if not cfg.moe_experts else cfg.moe_top_k * ff
        out["act_saved"] = 2.0 * L * Bl * S * d * 4.0
        out["act_stream"] = 3.0 * L * Bl * S * (2 * d + 2 * act_ff) * 4.0
    else:
        wbytes = weight_bits / 8.0
        out["weights"] = wbytes * N / tp
        if shape.kind == "prefill":
            out["act_stream"] = 2.0 * L * Bl * S * 2 * d * 2.0
        else:  # decode: read the whole local cache shard every token
            out["cache"] = _cache_bytes_total(cfg, shape, cache_bytes) / chips
            out["act_stream"] = L * Bl * 4 * d * 2.0
    out["total"] = sum(out.values())
    return out


def _cache_bytes_total(cfg: ModelConfig, shape: ShapeSpec,
                       kv_bytes: float = 2.0) -> float:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        H = cfg.d_model // 64
        return cfg.n_layers * B * (2 * cfg.d_model + H * 64 * 64) * 4.0
    if cfg.family == "hybrid":
        units = cfg.n_layers // 3
        nrec = cfg.n_layers - units
        W = min(S, cfg.window or S)
        rec = nrec * B * (3 * cfg.d_model + cfg.d_model) * 4.0
        att = units * B * W * cfg.n_kv * cfg.hd * 2 * kv_bytes
        return rec + att
    if cfg.family == "audio":
        self_c = cfg.n_layers * B * S * cfg.n_heads * cfg.hd * 2 * kv_bytes
        cross = cfg.n_layers * B * cfg.enc_seq * cfg.n_heads * cfg.hd * 2 \
            * kv_bytes
        return self_c + cross
    W = min(S, cfg.window or S)
    return cfg.n_layers * B * W * cfg.n_kv * cfg.hd * 2 * kv_bytes


def analytic_flops_total(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Global matmul FLOPs of one step (cross-check for the HLO parse)."""
    N = cfg.n_active_params()
    # embedding lookup contributes no matmul flops; tied head reuses table
    N_mm = N if cfg.tie_embeddings else N - cfg.vocab * cfg.d_model
    B, S = shape.global_batch, shape.seq_len
    T = B * (S if shape.kind != "decode" else 1)
    factor = 8.0 if shape.kind == "train" else 2.0  # fwd+bwd+remat vs fwd
    flops = factor / 2.0 * 2.0 * N_mm * T
    # attention score/value matmuls
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.hd
    if cfg.family == "ssm":
        Nh = cfg.d_model // 64
        flops += factor / 2.0 * 4.0 * B * (S if shape.kind != "decode" else 1) \
            * Nh * 64 * 64
    else:
        att_layers = L // 3 if cfg.family == "hybrid" else L
        if shape.kind == "decode":
            kv = min(S, cfg.window or S)
            flops += 4.0 * att_layers * B * kv * hd * H
        else:
            kv = min(S, cfg.window or S)
            causal = 0.5 if (cfg.window is None or S <= cfg.window) else 1.0
            flops += factor / 2.0 * 4.0 * att_layers * B * S * kv * hd * H \
                * causal
        if cfg.family == "audio":
            flops += factor / 2.0 * 4.0 * cfg.enc_layers * B \
                * cfg.enc_seq ** 2 * hd * H
            dec_T = B * (S if shape.kind != "decode" else 1)
            flops += factor / 2.0 * 4.0 * L * dec_T * cfg.enc_seq * hd * H
    return flops
