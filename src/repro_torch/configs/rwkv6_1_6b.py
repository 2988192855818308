"""rwkv6-1.6b [ssm] 24L d2048 attn-free ff7168 v65536 — Finch data-dependent decay (arXiv:2404.05892)"""
from ..models.config import ModelConfig
from ..nn.common import HGQConfig

_HGQ = HGQConfig(weight_gran="per_channel", act_gran="per_tensor",
                 init_weight_f=6.0, init_act_f=6.0)

FULL = ModelConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    n_heads=32, n_kv=32, d_ff=7168, vocab=65536, norm="ln",
    hgq=_HGQ)

SMOKE = ModelConfig(
    name="rwkv6-1.6b-smoke", family="ssm", n_layers=2, d_model=128,
    n_heads=2, n_kv=2, d_ff=256, vocab=256, norm="ln", rwkv_chunk=8,
    hgq=_HGQ)
