"""whisper-large-v3 [audio] enc-dec 32L d1280 20H MHA kv=20 ff5120 v51866 — conv frontend STUB (arXiv:2212.04356)"""
from ..models.config import ModelConfig
from ..nn.common import HGQConfig

_HGQ = HGQConfig(weight_gran="per_channel", act_gran="per_tensor",
                 init_weight_f=6.0, init_act_f=6.0)

FULL = ModelConfig(
    name="whisper-large-v3", family="audio", n_layers=32, enc_layers=32,
    enc_seq=1500, d_model=1280, n_heads=20, n_kv=20, d_ff=5120,
    vocab=51866, norm="ln", act="gelu",
    hgq=_HGQ)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio", n_layers=2, enc_layers=2,
    enc_seq=16, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
    norm="ln", act="gelu", q_chunk=32, k_chunk=32,
    hgq=_HGQ)
