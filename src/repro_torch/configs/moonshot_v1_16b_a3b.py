"""moonshot-v1-16b-a3b [moe] 48L d2048 16H GQA kv=16 ff1408/expert v163840 MoE 64e top-6 (hf:moonshotai/Moonlight-16B-A3B)"""
from ..models.config import ModelConfig
from ..nn.common import HGQConfig

_HGQ = HGQConfig(weight_gran="per_channel", act_gran="per_tensor",
                 init_weight_f=6.0, init_act_f=6.0)

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv=16, d_ff=1408, vocab=163840, moe_experts=64,
    moe_top_k=6, rope_theta=50000.0,
    hgq=_HGQ)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv=4, d_ff=32, vocab=256, moe_experts=8, moe_top_k=2,
    q_chunk=32, k_chunk=32,
    hgq=_HGQ)
