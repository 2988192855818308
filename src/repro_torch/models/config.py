"""Model configuration schema (counterpart of ``repro/models/config.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..nn.common import HGQConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None         # local-attention window
    attn_pattern: Tuple[str, ...] = ()
    moe_experts: int = 0
    moe_top_k: int = 0
    enc_layers: int = 0
    enc_seq: int = 1500
    n_patches: int = 0
    act: str = "silu"
    norm: str = "rms"            # rms | ln
    tie_embeddings: bool = False
    dtype: str = "float32"
    remat: bool = True
    q_chunk: int = 1024
    k_chunk: int = 1024
    rwkv_chunk: int = 64
    hgq: HGQConfig = dataclasses.field(
        default_factory=lambda: HGQConfig(weight_gran="per_channel",
                                          act_gran="per_tensor",
                                          init_weight_f=6.0, init_act_f=6.0))

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def np_dtype(self) -> torch.dtype:
        """The parameters' dtype (the reference's name for it)."""
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.dtype]

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts (SSM / hybrid: O(1) or
        O(window) state)?"""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (embedding + layers [+ encoder]), the
        reference's formula (norm scales and biases left out)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd \
            + self.n_heads * hd * d
        if self.family == "ssm":  # rwkv6: r,k,v,g,o (d*d) + ffn + decay lora
            layer = 5 * d * d + 2 * d * ff + d * ff + 2 * d * 64
        elif self.moe_experts:
            layer = attn + self.moe_experts * 3 * d * ff + d * self.moe_experts
        else:
            layer = attn + 3 * d * ff if self.act == "silu" \
                else attn + 2 * d * ff
        if self.family == "hybrid":
            # 2/3 recurrent blocks (~(3 d*dr + 2 dr^2 + conv) with dr = d)
            rec = 3 * d * d + 2 * d * d
            layer = (2 * rec + attn) / 3 + 3 * d * ff
        total = self.n_layers * layer \
            + V * d * (1 if self.tie_embeddings else 2)
        if self.enc_layers:
            total += self.enc_layers * (4 * d * d + 2 * d * ff)
            total += self.n_layers * 2 * d * d  # cross-attention extra
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.moe_experts:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        dense_share = self.n_params() \
            - self.n_layers * self.moe_experts * 3 * d * ff
        return int(dense_share + self.n_layers * self.moe_top_k * 3 * d * ff)
