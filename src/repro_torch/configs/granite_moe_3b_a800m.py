"""granite-moe-3b-a800m [moe] 32L d1536 24H GQA kv=8 ff512/expert v49155 MoE 40e top-8 (hf:ibm-granite)"""
from ..models.config import ModelConfig
from ..nn.common import HGQConfig

_HGQ = HGQConfig(weight_gran="per_channel", act_gran="per_tensor",
                 init_weight_f=6.0, init_act_f=6.0)

FULL = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv=8, d_ff=512, vocab=49155, moe_experts=40,
    moe_top_k=8, rope_theta=10000.0,
    hgq=_HGQ)

SMOKE = ModelConfig(
    name="granite-smoke", family="moe", n_layers=2, d_model=48,
    n_heads=4, n_kv=2, d_ff=16, vocab=256, moe_experts=5, moe_top_k=2,
    q_chunk=32, k_chunk=32,
    hgq=_HGQ)
