"""Architecture registry + assigned input shapes (counterpart of
``repro/configs/base.py``).

Each ``configs/<id>.py`` defines ``FULL`` (the exact published config)
and ``SMOKE`` (a reduced same-family config for CPU tests); :func:`get`
resolves a public id or a module name.  Every config loads, whether the
port runs its family yet or not: ``models.model_for`` is what refuses
one.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

from ..models.config import ModelConfig

ARCHS = (
    "llama3_2_3b", "qwen2_0_5b", "deepseek_67b", "qwen1_5_110b",
    "pixtral_12b", "rwkv6_1_6b", "moonshot_v1_16b_a3b",
    "granite_moe_3b_a800m", "recurrentgemma_2b", "whisper_large_v3",
)

# public ids (hyphenated) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({
    "llama3.2-3b": "llama3_2_3b", "qwen2-0.5b": "qwen2_0_5b",
    "deepseek-67b": "deepseek_67b", "qwen1.5-110b": "qwen1_5_110b",
    "pixtral-12b": "pixtral_12b", "rwkv6-1.6b": "rwkv6_1_6b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-large-v3": "whisper_large_v3",
})


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get(arch: str, smoke: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"{__package__}.{mod_name}")
    return mod.SMOKE if smoke else mod.FULL


def cells() -> Tuple[Tuple[str, str], ...]:
    """All 40 (arch x shape) cells; the caller resolves the ones an arch
    skips through ``ModelConfig.sub_quadratic``."""
    return tuple((a, s) for a in ARCHS for s in SHAPES)
