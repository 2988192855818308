"""llama3.2-3b [dense] 28L d3072 24H GQA kv=8 ff8192 v128256 (hf:meta-llama/Llama-3.2-1B; unverified)"""
from ..models.config import ModelConfig
from ..nn.common import HGQConfig

_HGQ = HGQConfig(weight_gran="per_channel", act_gran="per_tensor",
                 init_weight_f=6.0, init_act_f=6.0)

FULL = ModelConfig(
    name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv=8, d_ff=8192, vocab=128256, rope_theta=500000.0,
    tie_embeddings=True,
    hgq=_HGQ)

SMOKE = ModelConfig(
    name="llama3.2-3b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv=2, d_ff=128, vocab=256, rope_theta=500000.0,
    tie_embeddings=True, q_chunk=32, k_chunk=32,
    hgq=_HGQ)
