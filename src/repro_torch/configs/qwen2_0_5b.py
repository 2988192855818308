"""qwen2-0.5b [dense] 24L d896 14H GQA kv=2 ff4864 v151936, QKV bias,
tied embeddings (arXiv:2407.10671)."""
from ..models.config import ModelConfig
from ..nn.common import HGQConfig

_HGQ = HGQConfig(weight_gran="per_channel", act_gran="per_tensor",
                 init_weight_f=6.0, init_act_f=6.0)

FULL = ModelConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv=2, d_ff=4864, vocab=151936, qkv_bias=True,
    rope_theta=1000000.0, tie_embeddings=True,
    hgq=_HGQ)

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke", family="dense", n_layers=2, d_model=56,
    n_heads=14, n_kv=2, d_ff=112, vocab=256, qkv_bias=True,
    tie_embeddings=True, q_chunk=32, k_chunk=32,
    hgq=_HGQ)
