"""pixtral-12b [vlm] 40L d5120 32H GQA kv=8 ff14336 v131072 — ViT frontend STUB (hf:mistralai/Pixtral-12B-2409)"""
from ..models.config import ModelConfig
from ..nn.common import HGQConfig

_HGQ = HGQConfig(weight_gran="per_channel", act_gran="per_tensor",
                 init_weight_f=6.0, init_act_f=6.0)

FULL = ModelConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
    n_heads=32, n_kv=8, d_ff=14336, vocab=131072, head_dim=128,
    rope_theta=1000000.0, n_patches=256,
    hgq=_HGQ)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv=2, d_ff=128, vocab=256, n_patches=8,
    q_chunk=32, k_chunk=32,
    hgq=_HGQ)
