"""Model configuration schema (counterpart of ``repro/models/config.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
