"""recurrentgemma-2b [hybrid] 26L d2560 10H MQA kv=1 ff7680 v256000 — RG-LRU + local attn 1:2 (arXiv:2402.19427)"""
from ..models.config import ModelConfig
from ..nn.common import HGQConfig

_HGQ = HGQConfig(weight_gran="per_channel", act_gran="per_tensor",
                 init_weight_f=6.0, init_act_f=6.0)

FULL = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv=1, d_ff=7680, vocab=256000, window=2048,
    act="gelu",
    hgq=_HGQ)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid", n_layers=5, d_model=40,
    n_heads=4, n_kv=1, d_ff=80, vocab=256, window=16, act="gelu",
    q_chunk=16, k_chunk=16,
    hgq=_HGQ)
