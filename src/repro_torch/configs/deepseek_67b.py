"""deepseek-67b [dense] 95L d8192 64H GQA kv=8 ff22016 v102400, llama-arch (arXiv:2401.02954)"""
from ..models.config import ModelConfig
from ..nn.common import HGQConfig

_HGQ = HGQConfig(weight_gran="per_channel", act_gran="per_tensor",
                 init_weight_f=6.0, init_act_f=6.0)

FULL = ModelConfig(
    name="deepseek-67b", family="dense", n_layers=95, d_model=8192,
    n_heads=64, n_kv=8, d_ff=22016, vocab=102400, rope_theta=10000.0,
    hgq=_HGQ)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke", family="dense", n_layers=3, d_model=64,
    n_heads=8, n_kv=2, d_ff=160, vocab=256, q_chunk=32, k_chunk=32,
    hgq=_HGQ)
