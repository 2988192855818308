"""qwen1.5-110b [dense] 80L d8192 64H GQA kv=8 ff49152 v152064, QKV bias (hf:Qwen/Qwen1.5-0.5B)"""
from ..models.config import ModelConfig
from ..nn.common import HGQConfig

_HGQ = HGQConfig(weight_gran="per_channel", act_gran="per_tensor",
                 init_weight_f=6.0, init_act_f=6.0)

FULL = ModelConfig(
    name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv=8, d_ff=49152, vocab=152064, qkv_bias=True,
    rope_theta=1000000.0,
    hgq=_HGQ)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=8, n_kv=2, d_ff=384, vocab=256, qkv_bias=True,
    q_chunk=32, k_chunk=32,
    hgq=_HGQ)
